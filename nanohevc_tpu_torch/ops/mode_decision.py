"""Intra mode decision over the block tensor, port of `decide_modes`
in `nanohevc_tpu/models/all_intra.py`.

`decide_modes` picks each block's mode by residual energy, SAD, SATD or
the true RD cost (SSE + lambda * bits through the real transform chain
and the adaptive rate model of `ops.rate`, optionally plus lambda times
each candidate's MPM bits).  The open-loop pipelines of
`models.all_intra` and the plain versions of the kernel wrappers
(`kernels.mode_search`, `kernels.wavefront`, `kernels.wavefront_rd`)
all decide through it.

Mode numbering: 0 planar, 1 DC, 2..34 angular.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.ops import rate
from nanohevc_tpu_torch.ops.intra import DC_MODE, PLANAR_MODE
from nanohevc_tpu_torch.ops.mode_rate import mode_bits_for_grid
from nanohevc_tpu_torch.ops.rate import _rd_lambda


def _clip(x: torch.Tensor, bit_depth: int) -> torch.Tensor:
    return x.clamp(0, (1 << bit_depth) - 1)


def _cost(blocks: torch.Tensor, pred: torch.Tensor, decision: str) -> torch.Tensor:
    if decision == "energy":
        return ops.residual_energy_blocks(blocks - pred)
    if decision == "satd":
        return ops.satd_blocks(blocks, pred)
    return ops.sad_blocks(blocks, pred)


# Elements (block x mode x pixel) the 35-mode search holds per chunk of
# angular modes: bounds its temporaries at about 2^23 int32/float64
# values whatever the plane size.
_SEARCH_CHUNK_ELEMS = 1 << 23

def _rd_parts(blocks: torch.Tensor, preds: torch.Tensor, n: int, qp: int,
              use_dst: bool, bit_depth: int, dequant_rescale: bool):
    """Each candidate's residual through the real chain: blocks
    (nb, N, N), preds (nb, M, N, N) -> (sse (nb*M,) float32, diag-packed
    levels (nb*M, N*N)), candidate-major within a block."""
    nb, m = preds.shape[:2]
    flat_pred = preds.reshape(nb * m, n, n)
    blk = blocks[:, None].expand(preds.shape).reshape(nb * m, n, n)
    levels = ops.quantize(ops.forward_transform(blk - flat_pred, use_dst),
                          qp, n, True)
    rec_res = ops.inverse_transform(
        ops.dequantize(levels, qp, n, rescale=dequant_rescale), use_dst)
    recon = _clip(flat_pred + rec_res, bit_depth)
    diff = (blk - recon).to(torch.int64)
    # exact integer SSE, rounded once (JAX's float32 sum is exact below 2^24)
    sse = (diff * diff).sum(dim=(1, 2)).to(torch.float32)
    return sse, ops.scan_pack(levels, "diag")


def _rd_costs(blocks: torch.Tensor, preds: torch.Tensor, n: int, qp: int,
              use_dst: bool, bit_depth: int, dequant_rescale: bool,
              rd_lambda_scale: float) -> torch.Tensor:
    """True rate-distortion cost per (block, candidate): blocks
    (nb, N, N), preds (nb, M, N, N) -> (nb, M) float32 SSE + lambda *
    bits, the bits from the adaptive rate model over these nb*M rows."""
    nb, m = preds.shape[:2]
    sse, packed = _rd_parts(blocks, preds, n, qp, use_dst, bit_depth,
                            dequant_rescale)
    bits = rate.model_bits_adaptive(packed)
    lam = float(_rd_lambda(qp, rd_lambda_scale))
    return (sse + lam * bits).reshape(nb, m)


def _rd_angular_costs(blocks: torch.Tensor, refs_in: torch.Tensor, n: int,
                      routed: bool, qp: int, use_dst: bool, bit_depth: int,
                      dequant_rescale: bool, rd_lambda_scale: float
                      ) -> torch.Tensor:
    """`_rd_costs` of the 33 angular modes, (nb, 33), in chunks of modes.

    The adaptive model prices from the whole nb x 33 batch, as JAX's one
    call does: every chunk's bins are counted first (exact integers),
    the batch is priced once, then each chunk's bits and costs follow.
    A single chunk keeps its levels between the two passes.
    """
    nb = blocks.shape[0]
    step = max(1, _SEARCH_CHUNK_ELEMS // max(1, nb * n * n))
    chunks = [ops.ALL_ANGULAR[s:s + step]
              for s in range(0, len(ops.ALL_ANGULAR), step)]

    def parts(modes):
        preds = ops.angular_predict_modes(refs_in, n, modes, routed)
        return _rd_parts(blocks, preds, n, qp, use_dst, bit_depth,
                         dequant_rescale)

    kept = None
    counts = 0
    for modes in chunks:
        kept = parts(modes)
        counts = counts + rate.adaptive_counts(kept[1])
    prices = rate.adaptive_prices(counts, n * n)
    lam = float(_rd_lambda(qp, rd_lambda_scale))
    costs = []
    for modes in chunks:
        sse, packed = kept if len(chunks) == 1 else parts(modes)
        costs.append((sse + lam * rate.adaptive_bits(packed, prices))
                     .reshape(nb, len(modes)))
    return torch.cat(costs, dim=1)


def decide_modes(blocks: torch.Tensor, refs: torch.Tensor, n: int,
                 mode_set: str, decision: str, smoothing: bool = False,
                 bit_depth: int = 8, qp: int | None = None,
                 use_dst: bool = False, dequant_rescale: bool = False,
                 rd_lambda_scale: float = 1.0,
                 grid: Tuple[int, int] | None = None,
                 mode_bits: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick the intra mode per block: (pred (nb, N, N), mode (nb,) int32).

    mode_set "dc_planar" decides by `decision` (energy, sad, satd or
    rd) with ties to DC; "all" searches planar, DC and angular 2..34
    with ties to the lowest mode index; "dc" and "planar" fix one mode.

    smoothing applies the [1 2 1] reference filter (spec 8.4.4.2.3) to
    the modes its filter-flag rule selects (DC never, nothing at 4x4).

    decision="rd" costs each candidate SSE + lambda(QP) * bits through
    the real transform/quant/recon chain (`_rd_costs`); it needs qp,
    and use_dst/dequant_rescale as the pipeline uses them.  With grid
    (nby, nbx) it adds lambda times each candidate's MPM signalling
    bits, the MPM lists taken from a first decision without them (two
    passes); mode_bits (nb, 35) gives those bits directly instead (the
    closed loop's exact neighbours).

    The angular modes are evaluated in chunks, so a full-size plane
    never holds all 33 predictions at once.
    """
    if decision not in ("energy", "sad", "satd", "rd"):
        raise ValueError(f"unknown decision: {decision}")
    if mode_set not in ("dc_planar", "all", "dc", "planar"):
        raise ValueError(f"unknown mode_set: {mode_set}")
    if decision == "rd" and qp is None:
        raise ValueError("decision='rd' needs qp at decide_modes()")
    flags = ops.mode_filter_flags(n) if smoothing else None
    refs_f = ops.smooth_refs(refs, n, bit_depth) if smoothing and n > 4 else refs
    dc = ops.dc_predict(refs, n)                     # DC always unfiltered
    pl = ops.planar_predict(
        refs_f if (flags is not None and flags[PLANAR_MODE]) else refs, n
    )
    nb = blocks.shape[0]
    if mode_set == "dc":
        return dc, torch.full((nb,), DC_MODE, dtype=torch.int32,
                              device=blocks.device)
    if mode_set == "planar":
        return pl, torch.full((nb,), PLANAR_MODE, dtype=torch.int32,
                              device=blocks.device)
    rd = decision == "rd"
    if rd:
        both = _rd_costs(blocks, torch.stack([dc, pl], dim=1), n, qp, use_dst,
                         bit_depth, dequant_rescale, rd_lambda_scale)
        cost_dc, cost_pl = both[:, 0], both[:, 1]
    else:
        cost_dc = _cost(blocks, dc, decision)
        cost_pl = _cost(blocks, pl, decision)
    mode_rate = rd and (grid is not None or mode_bits is not None)
    if mode_rate:
        lam = float(_rd_lambda(qp, rd_lambda_scale))
    if mode_set == "dc_planar":
        if mode_rate:
            if mode_bits is None:
                first = torch.where(cost_dc <= cost_pl, DC_MODE, PLANAR_MODE)
                mode_bits = mode_bits_for_grid(first.reshape(grid))
            cost_dc = cost_dc + lam * mode_bits[:, DC_MODE]
            cost_pl = cost_pl + lam * mode_bits[:, PLANAR_MODE]
        dc_wins = cost_dc <= cost_pl
        pred = torch.where(dc_wins[:, None, None], dc, pl)
        mode = torch.where(dc_wins, DC_MODE, PLANAR_MODE).to(torch.int32)
        return pred, mode

    routed = smoothing and n > 4
    refs_in = torch.cat([refs, refs_f], dim=1) if routed else refs
    if rd:
        # all 35 costs, [planar, DC, 2..34]: the mode-rate pass needs them
        costs = torch.cat([cost_pl[:, None], cost_dc[:, None],
                           _rd_angular_costs(blocks, refs_in, n, routed, qp,
                                             use_dst, bit_depth,
                                             dequant_rescale,
                                             rd_lambda_scale)], dim=1)
        if mode_rate:
            if mode_bits is None:
                first = costs.argmin(dim=1)
                mode_bits = mode_bits_for_grid(first.reshape(grid))
            costs = costs + lam * mode_bits
        best_mode = costs.argmin(dim=1).to(torch.int32)   # ties -> lowest
        ang = ops.intra._by_mode(refs_in, n, best_mode, routed)
        sel = best_mode[:, None, None]
        best_pred = torch.where(sel == PLANAR_MODE, pl,
                                torch.where(sel == DC_MODE, dc, ang))
        return best_pred, best_mode

    # 35-mode search: costs over [planar, DC, 2..34], strict < in mode
    # order, so ties go to the lowest index as JAX's argmin does.
    dc_wins = cost_dc < cost_pl
    best_cost = torch.where(dc_wins, cost_dc, cost_pl)
    best_mode = torch.where(dc_wins, DC_MODE, PLANAR_MODE).to(torch.int32)
    best_pred = torch.where(dc_wins[:, None, None], dc, pl)
    chunk = max(1, _SEARCH_CHUNK_ELEMS // max(1, nb * n * n))
    for start in range(0, len(ops.ALL_ANGULAR), chunk):
        modes = ops.ALL_ANGULAR[start:start + chunk]
        preds = ops.angular_predict_modes(refs_in, n, modes, routed)
        costs = _cost(blocks[:, None], preds, decision)      # (nb, c)
        arg = costs.argmin(dim=1)                            # first minimum
        low = costs.gather(1, arg[:, None])[:, 0]
        better = low < best_cost
        best_cost = torch.where(better, low, best_cost)
        best_mode = torch.where(better, (arg + modes[0]).to(torch.int32),
                                best_mode)
        pick = preds[torch.arange(nb, device=preds.device), arg]
        best_pred = torch.where(better[:, None, None], pick, best_pred)
    return best_pred, best_mode
