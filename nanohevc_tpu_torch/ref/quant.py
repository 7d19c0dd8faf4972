# Copy of nanohevc_tpu/ref/quant.py (only the import lines and reference paths differ).
"""Vectorized numpy quantization oracle (HEVC spec 8.6.3 / Table 8-10).

Behavioral parity with reference/nano_hevc/quant.py:25-178.
int64 intermediates; dead-zone offset (1<<shift)//3 intra, //6 inter.
"""

from __future__ import annotations

import numpy as np

from nanohevc_tpu_torch.tables import DEQUANT_SCALE, QUANT_SCALE

__all__ = [
    "QUANT_SCALE",
    "DEQUANT_SCALE",
    "get_qp_params",
    "quantize",
    "dequantize",
    "quantize_block",
    "dequantize_block",
    "estimate_bits",
    "count_nonzero",
    "is_all_zero",
]


def get_qp_params(qp: int) -> tuple[int, int]:
    """Split QP (clamped to 0..51) into (qp // 6, qp % 6)."""
    qp = max(0, min(51, qp))
    return qp // 6, qp % 6


def quantize(
    coeff: np.ndarray, qp: int, size: int, is_intra: bool = True
) -> np.ndarray:
    """level = sign(c) * ((|c| * MF + deadzone) >> (14 + qp//6 + log2(N)))."""
    qp_per, qp_rem = get_qp_params(qp)
    mf = QUANT_SCALE[qp_rem]
    shift = 14 + qp_per + (size.bit_length() - 1)
    offset = (1 << shift) // (3 if is_intra else 6)
    c = np.asarray(coeff)
    level = (np.abs(c).astype(np.int64) * mf + offset) >> shift
    return (np.sign(c) * level).astype(np.int32)


def dequantize(
    level: np.ndarray, qp: int, size: int, rescale: bool = False
) -> np.ndarray:
    """coeff = (level * scale) >> (4 - qp//6) with rounding, or << (qp//6 - 4).

    The reference's dequant shift ignores the block size (its quant.py
    :110-121), which undoes the forward shift exactly only at 4x4 and
    attenuates coded residuals by 2^(log2 N - 2) above that.
    rescale=True restores the spec-correct size term (shift becomes
    6 - log2 N - qp//6, matching the forward 14 + qp//6 + log2 N
    against MF*DS ~= 2^20); default False preserves reference parity.
    """
    qp_per, qp_rem = get_qp_params(qp)
    base = np.asarray(level).astype(np.int64) * DEQUANT_SCALE[qp_rem]
    shift = (6 - (size.bit_length() - 1) if rescale else 4) - qp_per
    if shift >= 1:
        out = (base + (1 << (shift - 1))) >> shift
    else:
        out = base << -shift
    return out.astype(np.int32)


def quantize_block(coeff: np.ndarray, qp: int, is_intra: bool = True) -> np.ndarray:
    """Quantize with block size inferred from the input shape."""
    return quantize(coeff, qp, coeff.shape[0], is_intra)


def dequantize_block(level: np.ndarray, qp: int) -> np.ndarray:
    """Dequantize with block size inferred from the input shape."""
    return dequantize(level, qp, level.shape[0])


def estimate_bits(level: np.ndarray) -> int:
    """Crude rate estimate: sum(log2(|l|+1)) + 2 per nonzero level."""
    a = np.abs(level)
    return int(np.sum(np.log2(a + 1) + (a > 0) * 2))


def count_nonzero(level: np.ndarray) -> int:
    """Number of non-zero quantized levels."""
    return int(np.count_nonzero(level))


def is_all_zero(level: np.ndarray) -> bool:
    """True when every level is zero (block can be skipped by entropy)."""
    return bool(np.all(np.asarray(level) == 0))
