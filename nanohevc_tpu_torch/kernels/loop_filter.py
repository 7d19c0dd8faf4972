"""The closed loop's loop filters: CUDA kernel wrappers and their plain
PyTorch versions.

No TPU kernel stands behind them: the JAX package runs deblocking and
SAO as XLA ops inside its closed-loop encode and decode
(`nanohevc_tpu/models/wavefront.py`, through `ops/deblock.py`,
`ops/sao.py` and `ops/sao_ctb.py`).  The port's plain versions are its
own `ops.deblock_plane`, `ops.sao.estimate_sao` / `apply_sao` and
`ops.sao_ctb.estimate_sao_ctb` / `apply_sao_ctb`, unchanged.  The
kernels give the same pixels and parameters bit for bit, in three
launches a plane batch:

- `deblock_planes`: `csrc/deblock.cu`, both passes fused, 32x64 tiles
  with a 4-sample halo in shared memory (cp.async copies, the next
  tile's in flight while a thread block filters this one), a thread a
  line of an edge;
- `sao_estimate`: `csrc/sao.cu`'s estimate kernel, a thread block a
  group of tiles: the 16 EO and 32 band counts and sums of each tile as
  96 int32 (`STAT_LAYOUT`, an output too), then in one warp, while the
  others count the next tile, the 34 candidates and their first
  minimum, and the merge pass on the neighbours' published choices (CTB
  SAO) or the plane's sums, decided by its last tile (per-plane SAO);
- `sao_apply`: its application kernel, one elementwise pass.

Each wrapper dispatches on the device of its input: a CPU tensor goes
to the plain version, a CUDA tensor to the kernel (build and launch
errors raise), any other device raises.  There is no fallback.  A
launch adds one to the wrapper's `launches`; the kernels run on the
current stream and do not synchronise, and the host passes every scalar
(QP, the four float32 prices) as an argument, so no call waits on the
card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.ops import sao as ops_sao
from nanohevc_tpu_torch.ops import sao_ctb as ops_ctb
from nanohevc_tpu_torch.ops.rate import _rd_lambda
from nanohevc_tpu_torch.ref.sao import SAO_OFF, max_offset

# A tile's statistics, 96 int32 in this order: EO counts and sums by
# class * 4 + category - 1, then band counts and sums by band.
STAT_LAYOUT = (("eo_cnt", 16), ("eo_sum", 16), ("bo_cnt", 32),
               ("bo_sum", 32))
STAT_INTS = 96
# Per-plane SAO sums statistics of tiles of 64 samples
# (`ops.sao.estimate_sao`).
FRAME_STATS_TILE = 64


@lru_cache(maxsize=None)
def cuda_kernels(name: str):
    """Build (at first use) and load library `name` ("deblock", "sao")."""
    from nanohevc_tpu_torch.kernels.build import KernelLibrary

    return KernelLibrary(name)


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a tensor, got {type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {x.device}")
    return x.device.type == "cuda"


def _launch_args(x: torch.Tensor) -> tuple:
    """(stream, device index) of a CUDA tensor."""
    index = (x.device.index if x.device.index is not None
             else torch.cuda.current_device())
    return torch.cuda.current_stream(x.device).cuda_stream, index


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> contiguous int32 (B, H, W)."""
    x = x.to(torch.int32)
    return x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()


def _tile_shift(tile: int) -> int:
    tile = int(tile)
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"the SAO tile must be a power of two, got {tile}")
    return tile.bit_length() - 1


# --- deblocking ---------------------------------------------------------------

def deblock_planes(planes: torch.Tensor, qp, bit_depth: int = 8,
                   is_chroma: bool = False) -> torch.Tensor:
    """Deblock (..., H, W) planes -> int32, same shape, as
    `ops.deblock_plane` (its plain version) does; qp a Python int or a
    (B,) tensor, one QP a plane of a (B, H, W) batch.  On a CUDA tensor
    one launch of `csrc/deblock.cu` for the whole batch."""
    if not _on_card(planes):
        return ops.deblock_plane(planes, qp, bit_depth=bit_depth,
                                 is_chroma=is_chroma)
    if not 8 <= bit_depth <= 16:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    x = _flat(planes)
    b, h, w = x.shape
    qps, qp_scalar = None, 0
    if isinstance(qp, torch.Tensor):
        qps = qp.to(device=x.device, dtype=torch.int32).reshape(-1)
        if qps.numel() != b:
            raise ValueError(f"deblock_planes needs {b} QPs, got "
                             f"{qps.numel()}")
        qps = qps.contiguous()
    else:
        qp_scalar = int(qp)
    out = torch.empty_like(x)
    if out.numel():
        stream, index = _launch_args(x)
        _check(cuda_kernels("deblock").lib.nhv_deblock(
            x.data_ptr(), b, h, w, bit_depth, int(is_chroma), qp_scalar,
            None if qps is None else qps.data_ptr(), out.data_ptr(), stream,
            index), "nhv_deblock")
        deblock_planes.launches += 1
    return out.reshape(planes.shape)


deblock_planes.launches = 0


# --- SAO statistics and decision: the estimate -------------------------------

def sao_statistics_reference(src: torch.Tensor, rec: torch.Tensor,
                             tile: int, bit_depth: int = 8) -> torch.Tensor:
    """Plain version of the estimate's statistics: `ops.sao.class_stats`
    in the kernel's layout, (..., nty, ntx, 96) int32."""
    batch = tuple(rec.shape[:-2])
    st = ops_sao.class_stats(_flat(src), _flat(rec), tile, bit_depth)
    b, _, nty, ntx = st["bo_cnt"].shape
    parts = [st[k].reshape(b, n, nty, ntx) for k, n in STAT_LAYOUT]
    out = torch.cat(parts, dim=1).permute(0, 2, 3, 1).to(torch.int32)
    return out.reshape(batch + (nty, ntx, STAT_INTS))


def sao_prices(qp: int, rd_lambda_scale: float = 1.0) -> tuple:
    """CTB SAO's four float32 prices, lambda * bits of an off, EO, BO and
    merge choice, as `ops.sao_ctb.estimate_sao_ctb` computes them."""
    lam = _rd_lambda(int(qp), rd_lambda_scale)
    return tuple(float(np.float32(lam * np.float32(bits)))
                 for bits in (ops_ctb.BITS_OFF, ops_ctb.BITS_EO,
                              ops_ctb.BITS_BO, ops_ctb.BITS_MERGE))


def _stats_dict(stats: torch.Tensor, grid_dims: int) -> dict:
    """(B, *g, 96) statistics -> the dict `ops.sao.candidate_deltas`
    takes: eo_cnt / eo_sum (B, 4, 4, *g), bo_cnt / bo_sum (B, 32, *g)."""
    s = stats.movedim(-1, 1)
    grid = tuple(s.shape[2:])
    out, at = {"grid_dims": grid_dims}, 0
    for key, n in STAT_LAYOUT:
        shape = (4, 4) if n == 16 else (32,)
        out[key] = s[:, at:at + n].reshape((s.shape[0],) + shape + grid)
        at += n
    return out


def sao_decide_reference(stats: torch.Tensor, *, bit_depth: int = 8,
                         prices=None, merge: bool = True) -> tuple:
    """Plain version of the estimate's decision, from statistics in the
    kernel's layout: that of `ops.sao.estimate_sao` (prices None: the
    tiles summed, wrapped to int32) or of `ops.sao_ctb.estimate_sao_ctb`
    (prices: off, EO, BO, merge), with the ops' helpers."""
    batch = tuple(stats.shape[:-3])
    st = stats.reshape((-1,) + tuple(stats.shape[-3:]))
    b = st.shape[0]
    cap = max_offset(bit_depth)
    if prices is None:
        tot = st.to(torch.int64).sum(dim=(1, 2)).to(torch.int32)
        d_eo, eo_offs, d_win, bo_offs = ops_sao.candidate_deltas(
            _stats_dict(tot, 0), cap)
        scores = torch.cat([d_eo.new_zeros(b, 1), d_eo, d_win], dim=-1)
        offs = torch.cat([eo_offs.new_zeros(b, 1, 4), eo_offs, bo_offs],
                         dim=-2)
        out = ops_sao.decide(scores, offs, 1)[:3]
        return tuple(x.reshape(batch + tuple(x.shape[1:])) for x in out)
    p_off, p_eo, p_bo, p_merge = prices
    grid = tuple(st.shape[1:3])
    sd = _stats_dict(st, 2)
    d_eo, eo_offs, d_win, bo_offs = ops_sao.candidate_deltas(sd, cap)
    scores = torch.cat([torch.full((b, 1) + grid, p_off, dtype=torch.float32,
                                   device=st.device),
                        d_eo + p_eo, d_win + p_bo], dim=1)
    offs = torch.cat([eo_offs.new_zeros((b, 1) + grid + (4,)), eo_offs,
                      bo_offs], dim=1)
    best = ops_sao.decide(scores, offs, 1)
    best = (best[3],) + best[:3]
    if merge:
        pass1 = best[1:]
        for ax in (2, 1):                                 # left, then up
            nt = ops_ctb._shifted(pass1[0], ax, SAO_OFF)
            nb = ops_ctb._shifted(pass1[1], ax, 0)
            no = ops_ctb._shifted(pass1[2], ax, 0)
            d_n = ops_ctb._delta_for_params(sd, nt, nb, no)
            cost = torch.where(nt == SAO_OFF, 0.0, d_n) + p_merge
            first = torch.zeros_like(cost, dtype=torch.bool)
            first.narrow(ax, 0, 1).fill_(True)
            cost = torch.where(first, float("inf"), cost)
            take = cost < best[0]
            best = (torch.where(take, cost, best[0]),
                    torch.where(take, nt, best[1]),
                    torch.where(take, nb, best[2]),
                    torch.where(take[..., None], no, best[3]))
    return tuple(x.reshape(batch + tuple(x.shape[1:])) for x in best[1:])


# The estimate's workspace on each card, by device index: (counters,
# words, planes, tiles).  `counters` holds the 64-bit ticket and its
# generation (COUNTER_INTS ints), then a done counter and 96 sums a
# plane for `planes` planes; `words` a published word a tile for
# `tiles` tiles.  Zeroed once here (grown, never shrunk) and left at
# rest by every launch but for the ticket's generation; a replaced
# workspace stays allocated, since a captured CUDA graph may still hold
# it.
COUNTER_INTS = 4
_WORKSPACES: dict = {}
_RETIRED: list = []


def _workspace(dev: torch.device, planes: int, tiles: int) -> tuple:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    ws = _WORKSPACES.get(index)
    if ws is not None and ws[2] >= planes and ws[3] >= tiles:
        return ws
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("sao_estimate: call it once outside CUDA graph "
                           "capture at this batch and tile count first (its "
                           "workspace is allocated and zeroed then)")
    planes = max(planes, 64, 2 * ws[2] if ws else 0)
    tiles = max(tiles, 1 << 16, 2 * ws[3] if ws else 0)
    if ws is not None:
        _RETIRED.append(ws)
    ws = _WORKSPACES[index] = (
        torch.zeros(COUNTER_INTS + planes * (1 + STAT_INTS),
                    dtype=torch.int32, device=dev),
        torch.zeros(tiles, dtype=torch.int64, device=dev), planes, tiles)
    return ws


def sao_estimate(src: torch.Tensor, rec: torch.Tensor, *, tile=None,
                 qp=None, bit_depth: int = 8, rd_lambda_scale: float = 1.0,
                 merge: bool = True, return_stats: bool = False):
    """SAO parameters of (..., H, W) src / rec planes.

    tile None: one parameter set a plane, (type (...), band_pos (...),
    offsets (..., 4)), as `ops.sao.estimate_sao`; a power of two: CTB
    SAO's maps over tiles of that size at `qp`, (..., nty, ntx) and
    (..., nty, ntx, 4), merge pass included where `merge`, as `ops.
    sao_ctb.estimate_sao_ctb`.  With `return_stats`, (parameters,
    statistics): the (..., nty, ntx, 96) int32 statistics in
    `STAT_LAYOUT` of the tiles the parameters come from (tiles of
    `FRAME_STATS_TILE` for per-plane SAO; plain version
    `sao_statistics_reference`).  On a CPU tensor the plain versions; on
    a CUDA tensor one launch of `csrc/sao.cu`'s estimate kernel, the
    statistics and the decision in one grid.  Calls on one card share a
    workspace, so they must not overlap on two streams.
    """
    stats_tile = FRAME_STATS_TILE if tile is None else tile
    if not _on_card(rec):
        if tile is None:
            params = ops_sao.estimate_sao(src, rec, bit_depth)
        else:
            params = ops_ctb.estimate_sao_ctb(src, rec, tile, qp, bit_depth,
                                              rd_lambda_scale, merge)
        if return_stats:
            return params, sao_statistics_reference(src, rec, stats_tile,
                                                    bit_depth)
        return params
    shift = _tile_shift(stats_tile)
    if not 5 <= bit_depth <= 16:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    if not stats_tile * stats_tile * ((1 << bit_depth) - 1) < 2 ** 31:
        raise ValueError(f"SAO tile {stats_tile} at {bit_depth} bits "
                         "overflows int32 statistics")
    if tuple(src.shape) != tuple(rec.shape) or src.device != rec.device:
        raise ValueError("sao_estimate needs src and rec of one shape on "
                         "one device")
    s, r = _flat(src), _flat(rec)
    b, h, w = r.shape
    nty, ntx = ops_sao.tile_grid(h, w, stats_tile)
    grid = () if tile is None else (nty, ntx)
    dev = r.device
    stats = torch.empty((b, nty, ntx, STAT_INTS), dtype=torch.int32,
                        device=dev)
    type_map = torch.empty((b,) + grid, dtype=torch.int32, device=dev)
    band_map = torch.empty_like(type_map)
    off_map = torch.empty((b,) + grid + (4,), dtype=torch.int32, device=dev)
    if stats.numel():
        mode = 0 if tile is None else (2 if merge else 1)
        prices = ((0.0,) * 4 if tile is None
                  else sao_prices(qp, rd_lambda_scale))
        counters, words, _, _ = _workspace(dev, b, b * nty * ntx)
        stream, index = _launch_args(r)
        _check(cuda_kernels("sao").lib.nhv_sao_estimate(
            s.data_ptr(), r.data_ptr(), b, h, w, shift, bit_depth, mode,
            max_offset(bit_depth), *prices, stats.data_ptr(),
            type_map.data_ptr(), band_map.data_ptr(), off_map.data_ptr(),
            counters.data_ptr(), words.data_ptr(), stream, index),
            "nhv_sao_estimate")
        sao_estimate.launches += 1
    batch = tuple(rec.shape[:-2])
    params = tuple(x.reshape(batch + tuple(x.shape[1:]))
                   for x in (type_map, band_map, off_map))
    if return_stats:
        return params, stats.reshape(batch + (nty, ntx, STAT_INTS))
    return params


sao_estimate.launches = 0


# --- SAO application ----------------------------------------------------------

def sao_apply(plane: torch.Tensor, type_map, band_map, off_map, tile=None,
              bit_depth: int = 8) -> torch.Tensor:
    """Apply SAO parameters to (..., H, W) planes -> int32, same shape.

    tile None: one parameter set a plane (type (...), band_pos (...),
    offsets (..., 4)), as `ops.sao.apply_sao`; a power of two: per-tile
    maps (..., nty, ntx) and (..., nty, ntx, 4), as `ops.sao_ctb.
    apply_sao_ctb`.  Parameters may be tensors or arrays (from a
    bitstream) and broadcast over the batch.  On a CUDA tensor one
    launch of `csrc/sao.cu`'s application kernel.
    """
    if not _on_card(plane):
        if tile is None:
            return ops_sao.apply_sao(plane, type_map, band_map, off_map,
                                     bit_depth)
        return ops_ctb.apply_sao_ctb(plane, type_map, band_map, off_map,
                                     tile, bit_depth)
    if not 5 <= bit_depth <= 16:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    batch = tuple(plane.shape[:-2])
    p = _flat(plane)
    b, h, w = p.shape
    if tile is None:
        shift, grid = max(h, w, 1).bit_length(), ()
    else:
        shift = _tile_shift(tile)
        grid = ops_sao.tile_grid(h, w, tile)
    cells = 1 if tile is None else grid[0] * grid[1]

    def as_maps(m, trailing=()):
        m = torch.as_tensor(m, dtype=torch.int32, device=p.device)
        return m.expand(batch + grid + trailing).reshape(
            (b, cells) + trailing).contiguous()

    maps = (as_maps(type_map), as_maps(band_map), as_maps(off_map, (4,)))
    out = torch.empty_like(p)
    if out.numel():
        stream, index = _launch_args(p)
        _check(cuda_kernels("sao").lib.nhv_sao_apply(
            p.data_ptr(), *(m.data_ptr() for m in maps), b, h, w, shift,
            bit_depth, out.data_ptr(), stream, index), "nhv_sao_apply")
        sao_apply.launches += 1
    return out.reshape(batch + (h, w))


sao_apply.launches = 0
