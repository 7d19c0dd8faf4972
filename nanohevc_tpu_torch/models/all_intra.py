"""All-intra encoder pipelines over the block tensor, port of
`nanohevc_tpu/models/all_intra.py` for the open-loop slice.

- `encode_plane_parity`: the reference CLI's predict-only encode (DC
  vs planar by residual energy, best prediction as the recon).
- `encode_plane_full`: the plain PyTorch front half: mode decision
  (DC/planar or all 35 modes, by energy, SAD, SATD or RD cost, optional
  reference smoothing), residual, forward transform, quantize (with
  optional RDOQ), scan-pack, dequantize, inverse transform,
  reconstruct, clip, optional RD coded-block decision.
- `encode_plane_fast`: DC/planar by energy through the hand-written
  CUDA kernel `kernels.slab_pipeline.slab_encode_plane`.
- `encode_plane_fast_modes`: the 35-mode SATD search through the
  hand-written CUDA kernel `kernels.mode_search.mode_search_encode_plane`.

`encode_frame_full` routes each plane exactly as the JAX package does:
to the slab kernel where `supports_fast_path` holds, to the mode-search
kernel where `supports_mode_search_fast_path` holds, to the plain path
otherwise; RD cbf and RDOQ (`rdo_cbf`, `rdoq`) always take the plain
path, and so does `decision="rd"`, whose costs go through the real
transform chain and the rate models of `ops.rate` (see `decide_modes`).

Mode numbering: 0 planar, 1 DC, 2..34 angular.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.frame import Frame, Plane
from nanohevc_tpu_torch.ref.metrics import psnr as psnr_host
from nanohevc_tpu_torch.ref.metrics import ssim as ssim_host
from nanohevc_tpu_torch import ops, resolve_device
from nanohevc_tpu_torch.kernels.mode_search import (
    mode_search_encode_plane,
    mode_search_supported,
)
from nanohevc_tpu_torch.kernels.slab_pipeline import (
    slab_encode_plane,
    slab_supported,
)
from nanohevc_tpu_torch.ops import rate
from nanohevc_tpu_torch.ops.intra import DC_MODE, PLANAR_MODE
from nanohevc_tpu_torch.ops.mode_rate import mode_bits_for_grid
from nanohevc_tpu_torch.ops.rate import _rd_lambda
from nanohevc_tpu_torch.ops.rdoq import rd_lambda_calibrated


# ---------------------------------------------------------------------------
# Mode decision
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Plane pipelines
# ---------------------------------------------------------------------------

def _clip(x: torch.Tensor, bit_depth: int) -> torch.Tensor:
    return x.clamp(0, (1 << bit_depth) - 1)


def encode_plane_parity(plane: torch.Tensor, n: int,
                        bit_depth: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predict-only encode of one plane (reference CLI semantics).

    (H, W) -> (recon (H, W) int32 with zero-filled dropped edges,
    dc_wins (nb,) bool).
    """
    h, w = plane.shape
    blocks = ops.tile_plane(plane.to(torch.int32), n)
    refs = ops.extract_refs(plane, n)
    pred, mode = decide_modes(blocks, refs, n, "dc_planar", "energy")
    recon = ops.untile_plane(_clip(pred, bit_depth), h, w)
    return recon, mode == DC_MODE


def _finish(recon: torch.Tensor, levels_blocks: torch.Tensor,
            modes: torch.Tensor, scan: str) -> dict:
    packed = ops.scan_pack(levels_blocks, scan, modes=modes)
    return {
        "recon": recon,
        "levels": packed,
        "modes": modes,
        "nnz": (packed != 0).sum(dim=1).to(torch.int32),
    }


def encode_plane_full(
    plane: torch.Tensor,
    qp: int,
    *,
    n: int,
    mode_set: str = "dc_planar",
    decision: str = "energy",
    use_dst: bool = False,
    is_intra: bool = True,
    bit_depth: int = 8,
    scan: str = "diag",
    rdo_cbf: bool = False,
    rdoq: bool = False,
    dequant_rescale: bool = False,
    rate_mode: str = "coder",
    rd_lambda_scale: float = 1.0,
    intra_smoothing: bool = False,
) -> dict:
    """Plain PyTorch front-half encode of one plane.

    rdoq re-decides the levels under D + lambda * R (`ops.rdoq`) before
    reconstruction, lambda calibrated to the codec's quantization step.
    rdo_cbf drops a block's residual (levels zeroed, recon = clipped
    prediction) where SSE(skip) <= SSE(coded) + lambda(QP) * bits, the
    bits from the adaptive model of the plane's packed levels
    (rate_mode "coder") or from sum(log2(|l|+1)) + 2 per nonzero (any
    other rate_mode).  rd_lambda_scale multiplies every lambda.

    Returns dict of tensors on the plane's device:
      recon  (H, W)    reconstruction (dropped edges copy the source)
      levels (nb, N*N) scan-ordered quantized levels
      modes  (nb,)     chosen intra mode per block
      nnz    (nb,)     non-zero level count per block
    """
    h, w = plane.shape
    src = plane.to(torch.int32)
    blocks = ops.tile_plane(src, n)
    refs = ops.extract_refs(src, n, boundary=1 << (bit_depth - 1))
    pred, modes = decide_modes(
        blocks, refs, n, mode_set, decision, smoothing=intra_smoothing,
        bit_depth=bit_depth, qp=qp, use_dst=use_dst,
        dequant_rescale=dequant_rescale, rd_lambda_scale=rd_lambda_scale,
        grid=(h // n, w // n))
    coeff = ops.forward_transform(blocks - pred, use_dst)
    levels = ops.quantize(coeff, qp, n, is_intra)
    if rdoq:
        lam = rd_lambda_calibrated(qp, n, use_dst, dequant_rescale,
                                   rd_lambda_scale)
        gain = ops.rdoq_gain(n, use_dst, coeff.device).expand(coeff.shape)
        packed = ops.rdoq_levels(
            ops.scan_pack(coeff, scan, modes=modes),
            ops.scan_pack(levels, scan, modes=modes),
            ops.scan_pack(gain, scan, modes=modes),
            qp, n, lam, dequant_rescale=dequant_rescale)
        levels = ops.scan_unpack(packed, scan, modes=modes)
    else:
        packed = ops.scan_pack(levels, scan, modes=modes)
    rec_res = ops.inverse_transform(
        ops.dequantize(levels, qp, n, rescale=dequant_rescale), use_dst
    )
    recon_blocks = _clip(pred + rec_res, bit_depth)
    if rdo_cbf:
        pred_clip = _clip(pred, bit_depth)
        d_coded = ops.residual_energy_blocks(blocks - recon_blocks)
        d_skip = ops.residual_energy_blocks(blocks - pred_clip)
        # rates follow the coder's scan-positional contexts
        bits = (ops.rate_model_bits_adaptive(packed) if rate_mode == "coder"
                else ops.estimate_bits_blocks(levels))
        lam = float(_rd_lambda(qp, rd_lambda_scale))
        skip = d_skip.to(torch.float32) <= d_coded.to(torch.float32) + lam * bits
        packed = torch.where(skip[:, None], 0, packed)
        recon_blocks = torch.where(skip[:, None, None], pred_clip, recon_blocks)
    recon = src.clone()
    nby, nbx = h // n, w // n
    recon[: nby * n, : nbx * n] = ops.untile_plane(
        recon_blocks, nby * n, nbx * n
    )
    return {
        "recon": recon,
        "levels": packed,
        "modes": modes,
        "nnz": (packed != 0).sum(dim=1).to(torch.int32),
    }


def encode_plane_fast(plane: torch.Tensor, qp: int, *, n: int,
                      bit_depth: int = 8, scan: str = "diag",
                      use_dst: bool = False,
                      dequant_rescale: bool = False) -> dict:
    """The DC/planar energy path through the slab kernel wrapper.

    Same outputs as `encode_plane_full` for N in {4, 8, 16, 32} and
    W % N == 0; the CUDA kernel runs on a CUDA plane, its plain
    version on a CPU plane.
    """
    src = plane.to(torch.int32).contiguous()
    out = slab_encode_plane(
        src, qp, n, bit_depth=bit_depth, use_dst=use_dst,
        dequant_rescale=dequant_rescale,
    )
    return _finish(out["recon"], out["levels"], out["modes"], scan)


def encode_plane_fast_modes(plane: torch.Tensor, qp: int, *, n: int,
                            bit_depth: int = 8, scan: str = "diag",
                            use_dst: bool = False,
                            dequant_rescale: bool = False) -> dict:
    """The 35-mode SATD search through the mode-search kernel wrapper.

    Same outputs as `encode_plane_full(mode_set="all",
    decision="satd")` for N in {4, 8, 16, 32} and W % N == 0; the CUDA
    kernel runs on a CUDA plane, its plain version on a CPU plane.
    """
    src = plane.to(torch.int32).contiguous()
    out = mode_search_encode_plane(
        src, qp, n, bit_depth=bit_depth, use_dst=use_dst,
        dequant_rescale=dequant_rescale,
    )
    return _finish(out["recon"], out["levels"], out["modes"], scan)


def supports_mode_search_fast_path(config: EncoderConfig, n: int, width: int,
                                   is_luma: bool = True) -> bool:
    """True when encode_plane_fast_modes covers this (config, plane) combo."""
    return (
        (config.mode_set if is_luma else config.chroma_modes()) == "all"
        and config.decision == "satd"
        and config.is_intra
        and not (config.intra_smoothing and is_luma)
        and mode_search_supported(n, width)
    )


def supports_fast_path(config: EncoderConfig, n: int, width: int,
                       is_luma: bool = True) -> bool:
    """True when encode_plane_fast covers this (config, plane) combo."""
    return (
        (config.mode_set if is_luma else config.chroma_modes()) == "dc_planar"
        and config.decision == "energy"
        and config.is_intra
        and not (config.intra_smoothing and is_luma)
        and slab_supported(n, width)
    )


# ---------------------------------------------------------------------------
# Frame-level host wrappers
# ---------------------------------------------------------------------------

def _planes(frame: Frame, recon: Frame):
    return (("Y", frame.y, recon.y), ("U", frame.u, recon.u),
            ("V", frame.v, recon.v))


def _to_device(plane: Plane, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(plane.data.astype(np.int32)).to(device)


def encode_frame_intra(frame: Frame, block_size: int,
                       output_path: str | None = None, *,
                       device: str | torch.device) -> Tuple[Frame, dict]:
    """Predict-only frame encode, reference-CLI compatible.

    Y uses block_size; U/V use block_size//2 floored at 4.  Returns
    (recon Frame, stats dict with "dc"/"planar"/"blocks" counts summed
    over all planes).
    """
    dev = resolve_device(device)
    recon = Frame.zeros(frame.height, frame.width, dtype=np.int16)
    stats = {"dc": 0, "planar": 0, "blocks": 0}
    chroma_bs = max(4, block_size // 2)
    for name, src, dst in _planes(frame, recon):
        bs = block_size if name == "Y" else chroma_bs
        rec, dc_wins = encode_plane_parity(_to_device(src, dev), bs, 8)
        dst.data[...] = rec.cpu().numpy().astype(np.int16)
        dc = int(dc_wins.sum())
        nb = int(dc_wins.shape[0])
        stats["dc"] += dc
        stats["planar"] += nb - dc
        stats["blocks"] += nb
    if output_path:
        with open(output_path, "wb") as f:
            f.write(recon.to_yuv420p())
    return recon, stats


def encode_plane_config(plane: torch.Tensor, config: EncoderConfig,
                        is_luma: bool) -> dict:
    """One plane under an EncoderConfig, routed like the JAX package:
    the slab kernel, else the mode-search kernel, where it applies and
    the config asks for neither RD cbf nor RDOQ; the plain path
    otherwise."""
    bs = config.block_size if is_luma else config.chroma_block_size()
    width = plane.shape[1]
    # RD cbf and RDOQ are stages of the plain path only
    rd_stages = config.rdo_cbf or config.rdoq
    for applies, fast in ((supports_fast_path, encode_plane_fast),
                          (supports_mode_search_fast_path,
                           encode_plane_fast_modes)):
        if not rd_stages and applies(config, bs, width, is_luma):
            return fast(
                plane, config.qp, n=bs, bit_depth=config.bit_depth,
                scan=config.scan, use_dst=config.use_dst(bs, is_luma),
                dequant_rescale=config.dequant_rescale,
            )
    return encode_plane_full(
        plane, config.qp, n=bs,
        mode_set=config.mode_set if is_luma else config.chroma_modes(),
        decision=config.decision,
        use_dst=config.use_dst(bs, is_luma),
        is_intra=config.is_intra,
        bit_depth=config.bit_depth,
        scan=config.scan,
        rdo_cbf=config.rdo_cbf,
        rdoq=config.rdoq,
        dequant_rescale=config.dequant_rescale,
        intra_smoothing=config.intra_smoothing and is_luma,
    )


def encode_frame_full(frame: Frame, config: EncoderConfig, *,
                      device: str | torch.device) -> Tuple[Frame, dict]:
    """Full front-half frame encode under an EncoderConfig.

    Returns (recon Frame, info) with the JAX package's keys: per-plane
    levels (nb, N*N) int32, modes (nb,) int32, nnz and block_size; the
    block count; psnr_y and ssim_y from the host oracle (`ref.metrics`).
    """
    dev = resolve_device(device)
    recon = Frame.zeros(frame.height, frame.width, dtype=np.int16)
    info = {"planes": {}, "blocks": 0}
    for name, src, dst in _planes(frame, recon):
        is_luma = name == "Y"
        out = encode_plane_config(_to_device(src, dev), config, is_luma)
        dst.data[...] = out["recon"].cpu().numpy().astype(np.int16)
        info["planes"][name] = {
            "levels": out["levels"].cpu().numpy(),
            "modes": out["modes"].cpu().numpy(),
            "nnz": int(out["nnz"].sum()),
            "block_size": (config.block_size if is_luma
                           else config.chroma_block_size()),
        }
        info["blocks"] += int(out["modes"].shape[0])
    orig_y = frame.y.data.astype(np.uint8)
    rec_y = recon.y.data.astype(np.uint8)
    info["psnr_y"] = psnr_host(orig_y, rec_y)
    info["ssim_y"] = ssim_host(orig_y, rec_y)
    return recon, info


# ---------------------------------------------------------------------------
# Demo utilities
# ---------------------------------------------------------------------------

def create_test_frame(height: int, width: int) -> Frame:
    """Synthetic 4-quadrant test frame: horizontal gradient / vertical
    gradient / flat 128 / diagonal ramp min(255, 50+i+j)."""
    h2, w2 = height // 2, width // 2
    y = np.empty((height, width), dtype=np.uint8)
    y[:h2, :w2] = np.tile(np.linspace(50, 200, w2, dtype=np.uint8), (h2, 1))
    y[:h2, w2:] = np.tile(
        np.linspace(50, 200, h2, dtype=np.uint8).reshape(-1, 1), (1, width - w2)
    )
    y[h2:, :w2] = 128
    i = np.arange(height - h2).reshape(-1, 1)
    j = np.arange(width - w2).reshape(1, -1)
    y[h2:, w2:] = np.minimum(255, 50 + i + j).astype(np.uint8)
    u = np.full((h2, w2), 128, dtype=np.uint8)
    v = np.full((h2, w2), 128, dtype=np.uint8)
    return Frame(
        Plane(y.astype(np.int16)), Plane(u.astype(np.int16)), Plane(v.astype(np.int16))
    )
