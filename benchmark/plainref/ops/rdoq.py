# Frozen copy of nanohevc_tpu_torch/ops/rdoq.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""Rate-distortion optimized quantization (RDOQ), port of
`nanohevc_tpu/ops/rdoq.py`.

Deadzone levels are re-decided under D + lambda * R, block by block
(rows are independent; the rate is the static calibrated table of
`ops/rate.py`):

- stage A, level trim: each nonzero level l against l - 1, by pixel
  SSE through the transform gain plus lambda times its separable bits
  (a 1 -> 0 trim only before the block's last significant position);
- stage B, last position: for every candidate last position and the
  all-zero block, lambda * (cbf + last-position + prefix bits) plus the
  distortion of zeroing the tail, from prefix and suffix sums; the
  cheapest wins.

Encoder-only: a decoder dequantizes whatever levels arrive.  The
float32 arithmetic follows the JAX expressions elementwise and sums in
XLA's CPU order (`ops.rate.ordered_sum`, `ordered_cumsum`), so the
levels are JAX's bit for bit and the same on CPU and card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from plainref.ops import quant
from plainref.ops import rate as rate_mod
from plainref.ops.rate import f32, ordered_cumsum, ordered_sum
from plainref.tables import transform_matrix


@lru_cache(maxsize=None)
def _gain_matrix(n: int, use_dst: bool) -> np.ndarray:
    """(N, N) float32: pixel SSE per unit squared coefficient error
    through the two inverse-transform passes."""
    t = np.asarray(transform_matrix(n, use_dst), dtype=np.float64)
    row_norm2 = (t * t).sum(axis=1)                      # |t_i|^2
    shift = (n.bit_length() - 1) + 5                     # per pass
    g = np.outer(row_norm2, row_norm2) / float(2 ** (4 * shift))
    return g.astype(np.float32)


@lru_cache(maxsize=None)
def _gain_tensor(n: int, use_dst: bool, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_gain_matrix(n, use_dst)).to(device)


def rdoq_gain(n: int, use_dst: bool, device=None) -> torch.Tensor:
    """The (N, N) transform-gain matrix as a float32 tensor (made once
    per device)."""
    return _gain_tensor(n, use_dst, torch.device(device or "cpu"))


def rd_lambda_calibrated(qp: int, n: int, use_dst: bool,
                         dequant_rescale: bool, scale: float = 1.0
                         ) -> np.float32:
    """Lambda matched to this codec's true quantization step: 0.57 *
    2^(-8/3) * (pixel step)^2, the pixel step from dequantize(1) through
    the mean transform gain; float32 on the host, as JAX's float32
    products give it."""
    step_c = np.float32(int(quant.dequantize(
        torch.ones((1, 1), dtype=torch.int32), qp, n,
        rescale=dequant_rescale)[0, 0]))
    g_mean = np.float32(_gain_matrix(n, use_dst).mean())
    step_pix2 = np.float32(np.float32(g_mean * step_c) * step_c)
    return np.float32(np.float32(np.float32(scale)
                                 * np.float32(0.57 * 2.0 ** (-8.0 / 3.0)))
                      * step_pix2)


@lru_cache(maxsize=None)
def _last_cost_vec(ncoef: int, table_key: tuple) -> np.ndarray:
    """(ncoef,) model bits of coding 'last significant index = p', as
    `ops.rate.model_bits` prices the last position."""
    lastfull0, lastfull1, lastp0, lastp1 = table_key
    max_len = int(np.floor(np.log2(max(ncoef - 1, 2))))
    out = np.empty(ncoef, np.float32)
    for p in range(ncoef):
        if p == ncoef - 1:
            out[p] = lastfull1
            continue
        klen = (p + 1).bit_length() - 1
        c = lastfull0 + sum(lastp1[:klen]) + klen
        if klen < max_len:
            c += lastp0[klen]
        out[p] = c
    return out


@lru_cache(maxsize=None)
def _last_cost_tensor(ncoef: int, table_key: tuple, device: torch.device
                      ) -> torch.Tensor:
    return torch.from_numpy(_last_cost_vec(ncoef, table_key)).to(device)


def rdoq_levels(
    packed_coeff: torch.Tensor,
    packed_levels: torch.Tensor,
    packed_gain: torch.Tensor,
    qp: int,
    n: int,
    lam,
    *,
    dequant_rescale: bool = False,
    table: rate_mod.RateTable | None = None,
) -> torch.Tensor:
    """RD-adjust scan-ordered levels; all inputs scan-packed.

    packed_coeff (nb, ncoef) int32 transform coefficients,
    packed_levels (nb, ncoef) int32 deadzone levels, packed_gain
    (nb, ncoef) float32 transform gain per scan position, lam the
    pixel-SSE lambda.  Returns (nb, ncoef) int32 levels.
    """
    ncoef = packed_levels.shape[-1]
    if table is None:
        table = rate_mod.default_table(ncoef)
    dev = packed_levels.device
    lam = f32(lam)

    c = packed_coeff.to(torch.float32)
    g = packed_gain.to(torch.float32)
    lv = packed_levels.to(torch.int32)
    sgn = lv.sign()
    a = lv.abs()

    consts = rate_mod.table_tensors(table, ncoef, dev)
    sig0, sig1 = consts["sig0"], consts["sig1"]

    def gt_cost(aa):
        return torch.where(
            aa > 1,
            f32(table.gt1_1) + torch.where(
                aa > 2, f32(table.gt2_1) + rate_mod.eg0_bits(aa),
                f32(table.gt2_0)),
            f32(table.gt1_0))

    def coef_rate(aa):
        # separable syntax cost at an emitted-sig position
        return torch.where(aa > 0, sig1 + 1.0 + gt_cost(aa), sig0)

    def dist(aa):
        deq = quant.dequantize(sgn * aa, qp, n, rescale=dequant_rescale)
        d = c - deq.to(torch.float32)
        return g * d * d

    # stage A: per-coefficient level trim (l vs l-1)
    sig = a > 0
    lastidx = rate_mod._last_info(sig, ncoef)[0]
    before_last = torch.arange(ncoef, device=dev)[None, :] < lastidx[:, None]
    down = (a - 1).clamp(min=0)
    dist_down, rate_down = dist(down), coef_rate(down)
    dist_a, rate_a = dist(a), coef_rate(a)
    trim = sig & ((a > 1) | before_last) & (
        dist_down + lam * rate_down < dist_a + lam * rate_a)
    a = torch.where(trim, down, a)

    # stage B: optimal last position / all-zero block (the kept levels'
    # distortion and rate, elementwise, are stage A's of the chosen level)
    dist_keep = torch.where(trim, dist_down, dist_a)
    dist_zero = g * c * c
    zero_gain = dist_zero - dist_keep                    # D delta if zeroed
    ccoef = torch.where(trim, rate_down, rate_a)

    total_zero = ordered_sum(zero_gain)[:, None]
    suffix = total_zero - ordered_cumsum(zero_gain)      # sum over i > p
    prefix = ordered_cumsum(ccoef) - ccoef               # sum over i < p

    key = (
        float(table.lastfull0), float(table.lastfull1),
        tuple(float(x) for x in table.lastp0),
        tuple(float(x) for x in table.lastp1),
    )
    lastvec = _last_cost_tensor(ncoef, key, dev)

    # sig at p itself is inferred, not coded: subtract its sig1 price
    rate_p = f32(table.cbf1) + lastvec + prefix + (ccoef - sig1)
    cost_p = torch.where(a > 0, lam * rate_p + suffix, float("inf"))
    best_p = cost_p.argmin(dim=-1)                       # first minimum
    best_cost = cost_p.amin(dim=-1)
    # lambda * cbf0 is a float32 product, as in JAX
    cost_zero = f32(np.float32(lam) * np.float32(table.cbf0)) + total_zero[:, 0]
    all_zero = cost_zero <= best_cost

    keep = ((torch.arange(ncoef, device=dev)[None, :] <= best_p[:, None])
            & ~all_zero[:, None])
    return torch.where(keep, sgn * a, 0).to(torch.int32)
