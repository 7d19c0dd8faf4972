# Copy of nanohevc_tpu/ref/transform.py (only the import lines and reference paths differ).
"""Vectorized numpy transform oracle (HEVC spec 8.6).

Separable two-pass integer transform with per-pass rounding shift
log2(N)+5; behavioral parity with the reference triple loops
(reference/nano_hevc/transform.py:154-238) but expressed as two
int64 matrix products per pass.
"""

from __future__ import annotations

import numpy as np

from nanohevc_tpu_torch.tables import (
    DCT4,
    DCT8,
    DCT16,
    DCT32,
    DST4,
    transform_matrix,
)

__all__ = [
    "DCT4",
    "DCT8",
    "DCT16",
    "DCT32",
    "DST4",
    "forward_transform",
    "inverse_transform",
    "forward_transform_4x4",
    "inverse_transform_4x4",
    "forward_transform_8x8",
    "inverse_transform_8x8",
    "forward_transform_16x16",
    "inverse_transform_16x16",
    "forward_transform_32x32",
    "inverse_transform_32x32",
]


def _shift_round(x: np.ndarray, shift: int) -> np.ndarray:
    """(x + 2^(shift-1)) >> shift, arithmetic shift (floor)."""
    return (x + (1 << (shift - 1))) >> shift


def forward_transform(residual: np.ndarray, use_dst: bool = False) -> np.ndarray:
    """Forward transform: rows pass T @ X, then columns pass (.) @ T.T.

    Each pass applies the rounding shift log2(N)+5.  int64 intermediates
    make the matrix products exact for any int32 input.
    """
    size = residual.shape[0]
    t = transform_matrix(size, use_dst).astype(np.int64)
    shift = size.bit_length() - 1 + 5
    x = residual.astype(np.int64)
    temp = _shift_round(t @ x, shift)
    coeff = _shift_round(temp @ t.T, shift)
    return coeff.astype(np.int32)


def inverse_transform(coeff: np.ndarray, use_dst: bool = False) -> np.ndarray:
    """Inverse transform: T.T @ C, then (.) @ T, same per-pass shift."""
    size = coeff.shape[0]
    t = transform_matrix(size, use_dst).astype(np.int64)
    shift = size.bit_length() - 1 + 5
    x = coeff.astype(np.int64)
    temp = _shift_round(t.T @ x, shift)
    residual = _shift_round(temp @ t, shift)
    return residual.astype(np.int32)


def forward_transform_4x4(residual: np.ndarray, use_dst: bool = False) -> np.ndarray:
    """Forward 4x4 transform (convenience wrapper)."""
    return forward_transform(residual, use_dst)


def inverse_transform_4x4(coeff: np.ndarray, use_dst: bool = False) -> np.ndarray:
    """Inverse 4x4 transform (convenience wrapper)."""
    return inverse_transform(coeff, use_dst)


def forward_transform_8x8(residual: np.ndarray) -> np.ndarray:
    """Forward 8x8 DCT."""
    return forward_transform(residual)


def inverse_transform_8x8(coeff: np.ndarray) -> np.ndarray:
    """Inverse 8x8 DCT."""
    return inverse_transform(coeff)


def forward_transform_16x16(residual: np.ndarray) -> np.ndarray:
    """Forward 16x16 DCT."""
    return forward_transform(residual)


def inverse_transform_16x16(coeff: np.ndarray) -> np.ndarray:
    """Inverse 16x16 DCT."""
    return inverse_transform(coeff)


def forward_transform_32x32(residual: np.ndarray) -> np.ndarray:
    """Forward 32x32 DCT."""
    return forward_transform(residual)


def inverse_transform_32x32(coeff: np.ndarray) -> np.ndarray:
    """Inverse 32x32 DCT."""
    return inverse_transform(coeff)
