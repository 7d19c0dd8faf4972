# Frozen copy of nanohevc_tpu_torch/ops/sao_ctb.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""CTB-granular Sample Adaptive Offset (spec 8.7.3 at CTB grain), port
of `nanohevc_tpu/ops/sao_ctb.py`.

- Classification is full-plane (the filter reads across tile
  boundaries; only picture borders give category 0).  The integer
  statistics of every (plane, tile) come from one scatter-add a pass
  (`class_stats`: the four EO classes, then the 32 bands), over an
  index that combines plane, class or band, and tile.  The counts and
  sums are those of JAX's masked per-tile sums: integers, exact in any
  order, and far below int32's range (a tile holds at most 256^2
  samples of at most 12 bits).
- Each tile's (type, band_pos, offsets) is chosen by rate-distortion:
  the SSE delta of each of the 34 candidates plus lambda times its
  signalling bits (BITS_OFF / BITS_EO / BITS_BO), lambda being the RD
  lambda of `ops.rate._rd_lambda` (JAX's float32 value, exp2 from
  JAX's own bits).  A second pass offers each tile its left, then its
  upper neighbour's first-pass parameters at the merge price (strict
  `<`; no neighbour costs inf).  Float32 throughout, one op at a time
  in JAX's order, the first minimum winning (`ops/sao.py`).
- `apply_sao_ctb` (defined in `ops/sao.py`, with the classification
  and `class_stats`, and re-exported here) maps every sample to its
  tile's parameters and applies all types with masks; encoder and
  decoder share it, so round trips are pixel-exact.

Planes may be batched, (B, H, W) with (B, nty, ntx) maps: each frame
has its own parameters, and the maps stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from plainref.ops.rate import _rd_lambda
from plainref.ops.sao import (  # noqa: F401 (re-exported)
    _delta_sse,
    apply_sao_ctb,
    candidate_deltas,
    class_stats,
    decide,
    tile_grid,
)
from plainref.ref.sao import SAO_BO, SAO_EO0, SAO_OFF, max_offset

# Signalling cost per tile under the bit-packed syntax (merge bits are
# position-dependent 0-2 and charged separately by the merge pass).
BITS_OFF = 2.0
BITS_EO = 20.0    # 2 type + 2 class + 4 * 4-bit offsets
BITS_BO = 23.0    # 2 type + 5 band_pos + 4 * 4-bit offsets
BITS_MERGE = 2.0


def sao_tile_stats(src: torch.Tensor, rec: torch.Tensor, tile: int,
                   bit_depth: int = 8) -> dict:
    """Integer SAO statistics per tile, int32 as in JAX.

    src/rec (..., H, W) -> eo_cnt/eo_sum (..., 4, 4, nty, ntx)
    [eo_class, category-1, ty, tx] and bo_cnt/bo_sum (..., 32, nty,
    ntx) [band, ty, tx].  Classification is full-plane; only picture
    borders are category 0.
    """
    # |diff| < 2^bit_depth samples, at most tile^2 of them a tile.
    assert tile * tile * ((1 << bit_depth) - 1) < 2 ** 31, (tile, bit_depth)
    batch = tuple(rec.shape[:-2])
    flat = [x.to(torch.int32).reshape((-1,) + tuple(x.shape[-2:]))
            for x in (src, rec)]
    stats = class_stats(*flat, tile, bit_depth)
    return {k: v.to(torch.int32).reshape(batch + tuple(v.shape[1:]))
            for k, v in stats.items()}


def _delta_for_params(stats: dict, type_idx: torch.Tensor,
                      band_pos: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """Exact SSE delta of applying given params to each tile.

    stats as `sao_tile_stats` gives them; type_idx/band_pos (..., nty,
    ntx), offsets (..., nty, ntx, 4) -> (..., nty, ntx) float32.
    Computed from the integer stats, so it prices any parameter set
    (the merge pass prices the neighbours' parameters).
    """
    eo_cnt, eo_sum = stats["eo_cnt"], stats["eo_sum"]
    d = torch.zeros(type_idx.shape, dtype=torch.float32,
                    device=type_idx.device)
    for c in range(4):
        dc = torch.zeros_like(d)
        for k in range(4):
            dc = dc + _delta_sse(eo_cnt[..., c, k, :, :],
                                 eo_sum[..., c, k, :, :], offsets[..., k])
        d = torch.where(type_idx == SAO_EO0 + c, dc, d)
    bo_cnt = stats["bo_cnt"].movedim(-3, -1)             # (..., nty, ntx, 32)
    bo_sum = stats["bo_sum"].movedim(-3, -1)
    db = torch.zeros_like(d)
    for k in range(4):
        idx = ((band_pos + k) & 31).long()[..., None]
        db = db + _delta_sse(bo_cnt.gather(-1, idx)[..., 0],
                             bo_sum.gather(-1, idx)[..., 0], offsets[..., k])
    return torch.where(type_idx == SAO_BO, db, d)


def _shifted(m: torch.Tensor, axis: int, fill: int) -> torch.Tensor:
    """m moved one step along `axis` (towards higher indices), `fill`
    in the first row or column: every tile sees its left (upper)
    neighbour's value."""
    first = torch.full_like(m.narrow(axis, 0, 1), fill)
    return torch.cat([first, m.narrow(axis, 0, m.shape[axis] - 1)], dim=axis)


def estimate_sao_ctb(src: torch.Tensor, rec: torch.Tensor, tile: int, qp,
                     bit_depth: int = 8, rd_lambda_scale: float = 1.0,
                     merge: bool = True) -> tuple:
    """Per-tile RD-selected SAO parameters.

    (..., H, W) src/rec -> (type_map (..., nty, ntx), band_map (...,
    nty, ntx), off_map (..., nty, ntx, 4)) int32.  Cost = SSE delta +
    lambda * bits with the HEVC-style lambda(QP) (qp a Python int); the
    merge pass offers each tile its left/up neighbours' pass-1
    parameters at merge price.
    """
    stats = sao_tile_stats(src, rec, tile, bit_depth)
    cap = max_offset(bit_depth)
    lam = _rd_lambda(int(qp), rd_lambda_scale)
    price = {bits: float(np.float32(lam * np.float32(bits)))
             for bits in (BITS_OFF, BITS_EO, BITS_BO, BITS_MERGE)}
    batch = tuple(rec.shape[:-2])
    stats["grid_dims"] = 2
    d_eo, eo_offs, d_win, bo_offs = candidate_deltas(stats, cap)
    grid = tuple(d_eo.shape[-2:])
    axis = len(batch)
    scores = torch.cat([
        torch.full(batch + (1,) + grid, price[BITS_OFF], dtype=torch.float32,
                   device=d_eo.device),
        d_eo + price[BITS_EO],
        d_win + price[BITS_BO],
    ], dim=axis)                                          # (..., 34, nty, ntx)
    offs = torch.cat([eo_offs.new_zeros(batch + (1,) + grid + (4,)),
                      eo_offs, bo_offs], dim=axis)        # (..., 34, nty, ntx, 4)
    type_map, band_map, off_map, best_cost = decide(scores, offs, axis)
    if not merge:
        return type_map, band_map, off_map

    # Merge pass: adopt the left/up neighbour's pass-1 params when the
    # exact SSE of those params here plus the merge price beats our
    # own full-signalling cost.  Decode-side merge flags are derived
    # later by equality of final params, so this stays a decision only.
    best = (best_cost, type_map, band_map, off_map)
    for ax in (axis + 1, axis):                          # left, then up
        nt = _shifted(type_map, ax, SAO_OFF)
        nb = _shifted(band_map, ax, 0)
        no = _shifted(off_map, ax, 0)
        d_n = _delta_for_params(stats, nt, nb, no)
        d_n = torch.where(nt == SAO_OFF, 0.0, d_n)
        cost_n = d_n + price[BITS_MERGE]
        first = torch.zeros_like(cost_n, dtype=torch.bool)
        first.narrow(ax, 0, 1).fill_(True)
        cost_n = torch.where(first, float("inf"), cost_n)   # no neighbour
        take = cost_n < best[0]
        best = (
            torch.where(take, cost_n, best[0]),
            torch.where(take, nt, best[1]),
            torch.where(take, nb, best[2]),
            torch.where(take[..., None], no, best[3]),
        )
    return best[1], best[2], best[3]
