# Frozen copy of nanohevc_tpu_torch/ops/transform.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""Batched integer transforms (HEVC spec 8.6), port of
`nanohevc_tpu/ops/transform.py`.

CUDA has no int32 matmul, so each pass is a float64 matmul: every
product and partial sum is an integer far below 2^53 (a pass of the
32-point transform on 10-bit residuals stays below 2^23), so the
result is exact in any summation order, on the CPU and on the card.
TF32 never applies to float64.
"""

from __future__ import annotations

import torch

from plainref.params import encoder_tables


def _matrix(n: int, use_dst: bool, device) -> torch.Tensor:
    return encoder_tables(n, use_dst, device)["transform"].to(torch.float64)


def _round_shift(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """(exact float64 integer sum + rnd) >> shift, arithmetic, as int32."""
    return ((acc.to(torch.int64) + (1 << (shift - 1))) >> shift).to(torch.int32)


def forward_transform(blocks: torch.Tensor, use_dst: bool = False) -> torch.Tensor:
    """(nb, N, N) int32 residuals -> (nb, N, N) int32 coefficients."""
    n = blocks.shape[-1]
    t = _matrix(n, use_dst, blocks.device)
    shift = n.bit_length() - 1 + 5
    x = blocks.to(torch.float64)
    temp = _round_shift(torch.matmul(t, x), shift)
    return _round_shift(torch.matmul(temp.to(torch.float64), t.T), shift)


def inverse_transform(coeffs: torch.Tensor, use_dst: bool = False) -> torch.Tensor:
    """(nb, N, N) int32 coefficients -> (nb, N, N) int32 residuals."""
    n = coeffs.shape[-1]
    t = _matrix(n, use_dst, coeffs.device)
    shift = n.bit_length() - 1 + 5
    x = coeffs.to(torch.float64)
    temp = _round_shift(torch.matmul(t.T, x), shift)
    return _round_shift(torch.matmul(temp.to(torch.float64), t), shift)
