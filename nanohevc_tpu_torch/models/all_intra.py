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
transform chain and the rate models of `ops.rate` (see
`ops.mode_decision.decide_modes`).

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
from nanohevc_tpu_torch.ops.intra import DC_MODE
from nanohevc_tpu_torch.ops.mode_decision import _clip, decide_modes
from nanohevc_tpu_torch.ops.rate import _rd_lambda
from nanohevc_tpu_torch.ops.rdoq import rd_lambda_calibrated


# ---------------------------------------------------------------------------
# Plane pipelines
# ---------------------------------------------------------------------------

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
