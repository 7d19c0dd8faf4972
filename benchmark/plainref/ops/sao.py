# Frozen copy of nanohevc_tpu_torch/ops/sao.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""Sample Adaptive Offset (spec 8.7.3), one parameter set a plane, port
of `nanohevc_tpu/ops/sao.py`.

Classification is elementwise: an EO category from two rolled copies
of the plane under a border mask (a rolled value that wrapped around
never escapes the mask), a band index from one shift.  `apply_sao`
takes per-plane parameters as tensors, so a (B, H, W) batch of frames
with different SAO parameters is filtered in one pass, without a host
round trip.

Estimation statistics are integer counts and sums, exact in any order.
JAX gathers them with one masked sum per EO category and a scatter
over 32 bands; here they come from per-tile scatter-adds
(`class_stats`), summed over the tiles and wrapped to int32 as JAX's
int32 sums wrap.  The scoring is float32 in JAX's order,
one op at a time (`cnt*(o*o) - (2*o)*ssum`, the band window summed
((a+b)+c)+d, round half to even, no fused multiply-add), and the
34-candidate choice takes the first minimum, so the parameters equal
the JAX package's and the numpy oracle's on the CPU and on a card.

This module owns classification, statistics and application for both
grains: `class_stats` gives per-tile statistics and `apply_sao_ctb`
applies per-tile parameters; one parameter set a plane is the case of
one tile.  `ops/sao_ctb.py` adds the per-tile RD choice and merge pass.
"""

from __future__ import annotations

import torch

from plainref.ref.sao import (
    EO_NEIGHBORS,
    SAO_BO,
    SAO_EO0,
    SAO_OFF,
    max_offset,
)


def _valid_mask(h: int, w: int, eo_class: int, device) -> torch.Tensor:
    """(h, w) bool: both EO neighbours inside the picture (made on the
    device: no host copy, so no wait on the stream)."""
    dy0, dx0, dy1, dx1 = EO_NEIGHBORS[eo_class]
    m = torch.ones((h, w), dtype=torch.bool, device=device)
    for dy, dx in ((dy0, dx0), (dy1, dx1)):
        if dy < 0:
            m[:1] = False
        if dy > 0:
            m[-1:] = False
        if dx < 0:
            m[:, :1] = False
        if dx > 0:
            m[:, -1:] = False
    return m


def _eo_cat(p: torch.Tensor, eo_class: int) -> torch.Tensor:
    """(..., H, W) int32 EO category; border samples category 0."""
    dy0, dx0, dy1, dx1 = EO_NEIGHBORS[eo_class]
    n0 = torch.roll(p, (-dy0, -dx0), dims=(-2, -1))
    n1 = torch.roll(p, (-dy1, -dx1), dims=(-2, -1))
    ei = 2 + torch.sign(p - n0) + torch.sign(p - n1)
    # EDGE_CAT (1, 2, 0, 3, 4) by arithmetic, without a table upload.
    cat = torch.where(ei == 2, 0, torch.where(ei < 2, ei + 1, ei))
    valid = _valid_mask(p.shape[-2], p.shape[-1], eo_class, p.device)
    return torch.where(valid, cat, 0).to(torch.int32)


def _band_idx(p: torch.Tensor, bit_depth: int) -> torch.Tensor:
    return (p >> (bit_depth - 5)).to(torch.int32)


def tile_grid(h: int, w: int, tile: int) -> tuple[int, int]:
    return -(-h // tile), -(-w // tile)


def _tile_index(h: int, w: int, tile: int, device) -> torch.Tensor:
    """(H*W,) int64 raster tile index of every sample."""
    _, ntx = tile_grid(h, w, tile)
    ty = torch.arange(h, device=device) // tile
    tx = torch.arange(w, device=device) // tile
    return (ty[:, None] * ntx + tx[None, :]).reshape(-1)


def class_stats(src: torch.Tensor, rec: torch.Tensor, tile: int,
                bit_depth: int = 8) -> dict:
    """Integer SAO statistics of every (plane, tile), as int64.

    src/rec (B, H, W) -> eo_cnt/eo_sum (B, 4, 4, nty, ntx) [plane,
    eo_class, category-1, ty, tx] and bo_cnt/bo_sum (B, 32, nty, ntx)
    [plane, band, ty, tx].
    """
    b, h, w = rec.shape
    nty, ntx = tile_grid(h, w, tile)
    nt = nty * ntx
    dev = rec.device
    tix = _tile_index(h, w, tile, dev)
    plane = torch.arange(b, device=dev)[:, None]
    diff = (src.to(torch.int64) - rec.to(torch.int64)).reshape(-1)
    ones = torch.ones(1, dtype=torch.int64, device=dev).expand(diff.shape)

    def hist(key: torch.Tensor, nkeys: int) -> tuple:
        idx = ((plane * nkeys + key.reshape(b, -1).long()) * nt + tix
               ).reshape(-1)
        size = b * nkeys * nt
        cnt = torch.zeros(size, dtype=torch.int64, device=dev)
        ssum = torch.zeros(size, dtype=torch.int64, device=dev)
        cnt.index_add_(0, idx, ones)
        ssum.index_add_(0, idx, diff)
        return (cnt.reshape(b, nkeys, nty, ntx),
                ssum.reshape(b, nkeys, nty, ntx))

    eo = [hist(_eo_cat(rec, c), 5) for c in range(4)]
    bo_cnt, bo_sum = hist(_band_idx(rec, bit_depth), 32)
    return {
        "eo_cnt": torch.stack([c[:, 1:] for c, _ in eo], dim=1),
        "eo_sum": torch.stack([s[:, 1:] for _, s in eo], dim=1),
        "bo_cnt": bo_cnt,
        "bo_sum": bo_sum,
    }


def apply_sao_ctb(plane: torch.Tensor, type_map, band_map, off_map,
                  tile: int, bit_depth: int = 8) -> torch.Tensor:
    """Apply per-tile SAO parameters to (..., H, W) planes.

    type_map/band_map (..., nty, ntx) and off_map (..., nty, ntx, 4)
    (tensors, or arrays from a bitstream) give each tile's parameters;
    classification is full-plane, identical to the estimator's.
    """
    p = plane.to(torch.int32)
    batch, (h, w) = tuple(p.shape[:-2]), tuple(p.shape[-2:])
    dev = p.device
    nty, ntx = tile_grid(h, w, tile)
    pf = p.reshape(-1, h, w)
    bf = pf.shape[0]

    def maps(m, trailing=()):
        m = torch.as_tensor(m, dtype=torch.int32, device=dev)
        return m.expand(batch + (nty, ntx) + trailing).reshape(
            (bf, nty * ntx) + trailing)

    tix = _tile_index(h, w, tile, dev)
    type_pix = maps(type_map)[:, tix]                     # (bf, H*W)
    pos_pix = maps(band_map)[:, tix]
    # slot: which of the tile's 4 offsets a sample takes, -1 for none.
    slot = torch.full_like(type_pix, -1)
    for c in range(4):
        cat = _eo_cat(pf, c).reshape(bf, -1)
        slot = torch.where(type_pix == SAO_EO0 + c, cat - 1, slot)
    wi = (_band_idx(pf, bit_depth).reshape(bf, -1) - pos_pix) & 31
    slot = torch.where(type_pix == SAO_BO, torch.where(wi < 4, wi, -1), slot)
    off = maps(off_map, (4,)).reshape(bf, -1)
    delta = off.gather(1, tix * 4 + slot.clamp(min=0).long())
    delta = torch.where(slot >= 0, delta, 0)
    out = (pf.reshape(bf, -1) + delta).clamp(0, (1 << bit_depth) - 1)
    return out.reshape(batch + (h, w))


def apply_sao(plane: torch.Tensor, type_idx, band_pos, offsets,
              bit_depth: int = 8) -> torch.Tensor:
    """Apply (type_idx, band_pos, offsets[4]) to (..., H, W) planes.

    The parameters are ints/arrays for one plane or tensors of shapes
    (...), (...) and (..., 4), one set a plane; type SAO_OFF gives the
    input unchanged.  Bit-exact against ref/sao.apply_sao.
    """
    p = plane.to(torch.int32)
    batch, (h, w) = tuple(p.shape[:-2]), p.shape[-2:]
    tile = 1 << max(h, w, 1).bit_length()          # one tile a plane

    def one_tile(x, trailing=()):   # a value a plane -> a (1, 1) map each
        x = torch.as_tensor(x, dtype=torch.int32, device=p.device)
        return x.expand(batch + trailing).reshape(batch + (1, 1) + trailing)

    return apply_sao_ctb(p, one_tile(type_idx), one_tile(band_pos),
                         one_tile(offsets, (4,)), tile, bit_depth)


def _offset_from_stats(cnt: torch.Tensor, ssum: torch.Tensor, cap: int,
                       lo: int, hi: int) -> torch.Tensor:
    """Mirror of ref/sao._offset_from_stats: the float32 mean rounded
    half to even, clipped, 0 where nothing was counted."""
    o = torch.round(ssum.to(torch.float32)
                    / cnt.clamp(min=1).to(torch.float32))
    o = o.to(torch.int32).clamp(max(lo, -cap), min(hi, cap))
    return torch.where(cnt > 0, o, 0).to(torch.int32)


def _delta_sse(cnt: torch.Tensor, ssum: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """cnt*(o*o) - (2*o)*ssum in float32, one op at a time."""
    cnt = cnt.to(torch.float32)
    ssum = ssum.to(torch.float32)
    o = o.to(torch.float32)
    return cnt * (o * o) - (2.0 * o) * ssum


def first_argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 index of the first minimum along dim (the candidate order
    decides ties, as jnp.argmin does), spelled out so that it holds on
    every device."""
    idx = torch.arange(x.shape[dim], device=x.device, dtype=torch.int32)
    idx = idx.reshape((-1,) + (1,) * (x.dim() - 1 - (dim % x.dim())))
    hit = x == x.amin(dim=dim, keepdim=True)
    return torch.where(hit, idx, x.shape[dim]).amin(dim=dim).to(torch.int32)


def candidate_deltas(stats: dict, cap: int) -> tuple:
    """The 34 candidates' SSE deltas and offsets from integer stats.

    stats: eo_cnt/eo_sum (..., 4, 4, *g), bo_cnt/bo_sum (..., 32, *g)
    with g the tile grid (empty for per-plane stats; `...` the batch).
    Returns (eo (..., 4, *g) float32, eo_offs (..., 4, *g, 4) int32,
    bo (..., 29, *g) float32, bo_offs (..., 29, *g, 4) int32) in JAX's
    candidate order: EO classes 0-3, then BO windows at positions 0-28.
    """
    eo_cnt, eo_sum = stats["eo_cnt"], stats["eo_sum"]
    k_axis = eo_cnt.dim() - stats["grid_dims"] - 1
    offs, d_tot = [], None
    for k in range(4):
        cnt = eo_cnt.select(k_axis, k)
        ssum = eo_sum.select(k_axis, k)
        lo, hi = (0, cap) if k < 2 else (-cap, 0)
        o = _offset_from_stats(cnt, ssum, cap, lo, hi)
        offs.append(o)
        d = _delta_sse(cnt, ssum, o)
        d_tot = d if d_tot is None else d_tot + d
    eo_offs = torch.stack(offs, dim=-1)
    b_axis = stats["bo_cnt"].dim() - stats["grid_dims"] - 1
    o_b = _offset_from_stats(stats["bo_cnt"], stats["bo_sum"], cap, -cap, cap)
    d_b = _delta_sse(stats["bo_cnt"], stats["bo_sum"], o_b)

    def win(x, k):   # positions 0-28 shifted by k along the band axis
        return x.narrow(b_axis, k, 29)

    d_win = ((win(d_b, 0) + win(d_b, 1)) + win(d_b, 2)) + win(d_b, 3)
    bo_offs = torch.stack([win(o_b, k) for k in range(4)], dim=-1)
    return d_tot, eo_offs, d_win, bo_offs


def decide(scores: torch.Tensor, offs: torch.Tensor, axis: int) -> tuple:
    """(type, band_pos, offsets, winning score) of the first minimum of
    34 candidate scores along `axis` (candidate 0 off, 1-4 EO, 5-33 BO)."""
    idx = first_argmin(scores, axis)
    type_idx = torch.where(idx == 0, SAO_OFF,
                           torch.where(idx <= 4, idx, SAO_BO)).to(torch.int32)
    band_pos = torch.where(idx >= 5, idx - 5, 0).to(torch.int32)
    sel = idx.long().unsqueeze(axis)
    best = scores.gather(axis, sel).squeeze(axis)
    off = offs.gather(axis, sel.unsqueeze(-1).expand(
        sel.shape + (4,))).squeeze(axis)
    return type_idx, band_pos, off, best


def estimate_sao(src: torch.Tensor, rec: torch.Tensor,
                 bit_depth: int = 8) -> tuple:
    """(..., H, W) src/rec -> (type_idx (...), band_pos (...),
    offsets (..., 4)) int32, one parameter set a plane.

    Candidate order (off, EO 0-3, BO positions 0-28) and the float32
    scoring mirror the oracle, so ties resolve identically.
    """
    src = src.to(torch.int32)
    rec = rec.to(torch.int32)
    batch = tuple(rec.shape[:-2])
    tiles = class_stats(src.reshape((-1,) + src.shape[-2:]),
                        rec.reshape((-1,) + rec.shape[-2:]), 64, bit_depth)
    # Per-plane sums of the per-tile int64 stats, wrapped to int32 as
    # JAX's int32 sums wrap.
    stats = {k: v.sum(dim=(-2, -1)).to(torch.int32).reshape(
        batch + v.shape[1:-2]) for k, v in tiles.items()}
    stats["grid_dims"] = 0
    d_eo, eo_offs, d_win, bo_offs = candidate_deltas(
        stats, max_offset(bit_depth))
    zero = d_eo.new_zeros(batch + (1,))
    scores = torch.cat([zero, d_eo, d_win], dim=-1)             # (..., 34)
    offs = torch.cat([eo_offs.new_zeros(batch + (1, 4)), eo_offs, bo_offs],
                     dim=-2)                                     # (..., 34, 4)
    type_idx, band_pos, off, _ = decide(scores, offs, len(batch))
    return type_idx, band_pos, off
