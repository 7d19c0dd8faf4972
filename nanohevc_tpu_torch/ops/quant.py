"""Batched quantization / dequantization (HEVC spec 8.6.3, Table 8-10).

Port of `nanohevc_tpu/ops/quant.py` for a static Python-int QP.  All
arithmetic is int32 with the JAX package's exactness bounds:
|coeff| <= 65,000 for quantize (65000*26214 + 2^27/3 < 2^31) and
|level| <= 2^20 for dequantize.  Shifts are arithmetic.
"""

from __future__ import annotations

import torch

from nanohevc_tpu_torch.tables import DEQUANT_SCALE, QUANT_SCALE


def _qp_params(qp: int) -> tuple[int, int]:
    qp = max(0, min(51, int(qp)))
    return qp // 6, qp % 6


def quantize(coeffs: torch.Tensor, qp: int, n: int | None = None,
             is_intra: bool = True) -> torch.Tensor:
    """level = sign(c) * ((|c| * MF + deadzone) >> (14 + qp//6 + log2 N))."""
    if n is None:
        n = coeffs.shape[-1]
    qp_per, qp_rem = _qp_params(qp)
    shift = 14 + qp_per + (n.bit_length() - 1)
    offset = (1 << shift) // (3 if is_intra else 6)
    c = coeffs.to(torch.int32)
    level = (c.abs() * QUANT_SCALE[qp_rem] + offset) >> shift
    return c.sign() * level


def dequantize(levels: torch.Tensor, qp: int, n: int | None = None,
               rescale: bool = False) -> torch.Tensor:
    """coeff = (level*scale + rnd) >> (base - qp//6), or a left shift
    when that shift is <= 0.

    base is 4 (parity: the reference ignores the block size) or, with
    rescale, the spec-correct 6 - log2 N.
    """
    if n is None:
        n = levels.shape[-1]
    shift_base = 6 - (n.bit_length() - 1) if rescale else 4
    qp_per, qp_rem = _qp_params(qp)
    base = levels.to(torch.int32) * DEQUANT_SCALE[qp_rem]
    shift = shift_base - qp_per
    if shift >= 1:
        return (base + (1 << (shift - 1))) >> shift
    return base << (-shift)
