"""Closed-loop (wavefront) all-intra encode and the matching decoder,
port of `nanohevc_tpu/models/wavefront.py`.

Intra prediction here reads *reconstructed* neighbours, which orders
the blocks along anti-diagonals: the blocks of diagonal d (by + bx ==
d) depend only on diagonals before d, so each diagonal is coded as one
batch, and the frame takes nby + nbx - 1 dependent steps (374 for a
1080p luma plane at N = 8).  A block's references follow the closed
loop's availability rule, which is exactly `ops.extract_refs_at` on a
zero-filled reconstruction written one diagonal at a time: the
top-right and below-left extensions lie on the block's own diagonal
and read 0, except at the plane's last block-column (block-row), where
they replicate T[N] (L[N]); the plane's top row and left column, and
the corner there, read 1 << (bd - 1).

Routing (`encode_planes_closed_loop`), one rule:

- Every configuration but the RD decision of `dc_planar` and `all`
  goes to `kernels.wavefront.wavefront_encode_planes`: every mode set
  (`dc`, `planar`, `dc_planar`, `all`) under every per-block decision
  (`energy`, `sad`, `satd`), the fixed sets `dc` and `planar` under
  `rd` too (JAX's `decide_modes` returns before it prices a fixed
  mode), with or without luma reference smoothing
  and RDOQ (in `scan` order, lambda scaled by rd_lambda_scale), at
  every batch size.  On the card that is the hand-written CUDA kernel,
  one persistent launch per call: the port's counterpart of JAX's
  three Pallas kernels (K4, K3a/K3b) and of its XLA scan
  (models/wavefront.py:367-421 there), which give the same bits.  On
  the CPU the wrapper runs the plain loop
  `kernels.wavefront.wavefront_encode_planes_reference`.
  `allow_fast=True` keeps JAX's refusals: `rdoq`, `intra_smoothing`
  and the configurations no Pallas kernel of JAX takes raise
  ValueError (models/wavefront.py:301 there).
- `decision="rd"` with `dc_planar` or `all` prices its candidates
  with the adaptive rate model over the batch it is given, so it runs
  JAX's own batches: frame by frame, each diagonal on all nby slots of
  the JAX package's skewed layout, invalid slots included, with the skew
  tables and skewed boundary buffers ported for it.  It goes to
  `kernels.wavefront_rd.wavefront_rd_encode_planes`: on the card the
  hand-written CUDA kernel, one persistent cooperative launch per call
  that prices the batches on the card (the port's counterpart of the RD
  branch of JAX's XLA scan); on the CPU the plain loop
  `kernels.wavefront_rd.wavefront_rd_encode_planes_reference`.
- `kernel_split` and `unroll` are TPU layout knobs and are not taken.

The in-loop filters follow every route, on the padded recon and in
JAX's order: deblocking (chroma's p0/q0 filter with `deblock_chroma`),
then per-frame SAO or CTB SAO (tiles of `sao_tile`), each estimated
against the padded source, all through `kernels.loop_filter`: on the
card its CUDA kernels (four launches a plane batch), on the CPU the
plain `ops.deblock_plane`, `ops.sao` and `ops.sao_ctb`.  Intra
prediction reads the unfiltered recon, so levels and modes do not
change; the decoders apply the same filters with the parameters the
stream carries.

Non-block-aligned planes are padded by edge replication and the recon
cropped back (the conformance window), so `decode_plane` reproduces
the encoder's reconstruction pixel for pixel at any geometry.  The
decoder dequantizes and inverse-transforms every block's residual at
once, then predicts, adds and clips through `kernels.decode.decode_blocks`:
on the card one persistent CUDA launch per batch of planes (the port's
counterpart of the JAX decoder's compiled scan, which runs no Pallas
kernel), on the CPU the plain diagonal loop; then the filters.
"""

from __future__ import annotations

import numpy as np
import torch

from nanohevc_tpu_torch import ops, resolve_device
from nanohevc_tpu_torch.frame import Frame, Plane
from nanohevc_tpu_torch.kernels.decode import decode_blocks
from nanohevc_tpu_torch.kernels.loop_filter import (
    deblock_planes,
    sao_apply,
    sao_estimate,
)
from nanohevc_tpu_torch.kernels.wavefront import (
    FIXED_MODES,
    wavefront_encode_planes,
    wavefront_supported,
)
from nanohevc_tpu_torch.kernels.wavefront_rd import wavefront_rd_encode_planes
from nanohevc_tpu_torch.utils.tracing import count, span


def pad_to_blocks(planes: torch.Tensor, n: int) -> torch.Tensor:
    """(B, H, W) -> (B, Hp, Wp), block multiples, by edge replication."""
    b, h, w = planes.shape
    hp, wp = -(-h // n) * n, -(-w // n) * n
    if hp != h:
        planes = torch.cat(
            [planes, planes[:, h - 1:h, :].expand(b, hp - h, w)], dim=1)
    if wp != w:
        planes = torch.cat(
            [planes, planes[:, :, w - 1:w].expand(b, hp, wp - w)], dim=2)
    return planes.contiguous()


def encode_planes_closed_loop(
    planes: torch.Tensor,
    qp: int,
    *,
    n: int,
    mode_set: str = "dc_planar",
    decision: str = "energy",
    use_dst: bool = False,
    bit_depth: int = 8,
    scan: str = "diag",
    dequant_rescale: bool = False,
    intra_smoothing: bool = False,
    deblock: bool = False,
    deblock_chroma: bool = False,
    sao: bool = False,
    sao_ctb: bool = False,
    sao_tile: int = 64,
    rdoq: bool = False,
    rd_lambda_scale: float = 1.0,
    allow_fast: bool | None = None,
) -> dict:
    """Batched wavefront encode of (B, H, W) planes, reconstruction-fed.

    Returns {"recon" (B, H, W) int32, "levels" (B, nb, N*N) int32
    scan-packed in raster block order, "modes" (B, nb) int32} on the
    planes' device; nb counts the blocks of the padded geometry.  qp is
    a Python int.  decision="rd" with mode_set "dc_planar" or "all" runs
    `wavefront_rd_encode_planes`, every other configuration
    `wavefront_encode_planes` (on the card, a kernel each), whatever
    allow_fast says, except that allow_fast=True refuses, as JAX does,
    what no Pallas kernel of JAX takes (rdoq, intra_smoothing, other
    mode sets and decisions).  rdoq re-decides each block's levels
    inside the loop, its lambda scaled by rd_lambda_scale.
    The filters (deblock, then sao or sao_ctb) act on the recon; with
    sao the dict also holds "sao" ((B,) type, (B,) band_pos, (B, 4)
    offsets), with sao_ctb "sao_ctb" ((B, nty, ntx) type, band and
    (B, nty, ntx, 4) offset maps over tiles of sao_tile samples).
    """
    if sao and sao_ctb:
        raise ValueError("sao and sao_ctb are mutually exclusive")
    if rdoq and allow_fast:
        raise ValueError(
            "rdoq is not taken by the JAX package's Pallas kernels "
            "(they quantize with plain deadzone); pass allow_fast=False "
            "or None")
    if allow_fast and (not wavefront_supported(n, mode_set, decision, use_dst)
                       or intra_smoothing):
        raise ValueError(
            f"no Pallas kernel of the JAX package takes n={n}, mode_set="
            f"{mode_set!r}, decision={decision!r}, use_dst={use_dst}, "
            f"intra_smoothing={intra_smoothing}")
    b, h, w = planes.shape
    src = pad_to_blocks(planes.to(torch.int32), n)
    loop = dict(intra_smoothing=intra_smoothing, rdoq=rdoq, scan=scan,
                rd_lambda_scale=rd_lambda_scale)
    if decision == "rd" and mode_set not in FIXED_MODES:
        out = wavefront_rd_encode_planes(
            src, int(qp), n, mode_set=mode_set, use_dst=use_dst,
            bit_depth=bit_depth, dequant_rescale=dequant_rescale, **loop)
    else:
        out = wavefront_encode_planes(
            src, int(qp), n, mode_set=mode_set, decision=decision,
            bit_depth=bit_depth, use_dst=use_dst,
            dequant_rescale=dequant_rescale, **loop)
    nb = out["modes"].shape[1]
    levels = ops.scan_pack(out["levels"].reshape(b * nb, n, n), scan,
                           modes=out["modes"].reshape(b * nb))
    res = {"levels": levels.reshape(b, nb, n * n), "modes": out["modes"]}
    recon = out["recon"]
    if deblock:
        # An output filter on the padded recon: the wavefront predicted
        # from unfiltered samples, and the decoder filters alike.
        recon = deblock_planes(recon, int(qp), bit_depth=bit_depth,
                               is_chroma=deblock_chroma)
    if sao:
        res["sao"] = sao_estimate(src, recon, bit_depth=bit_depth)
        recon = sao_apply(recon, *res["sao"], bit_depth=bit_depth)
    if sao_ctb:
        res["sao_ctb"] = sao_estimate(src, recon, tile=sao_tile, qp=int(qp),
                                      bit_depth=bit_depth)
        recon = sao_apply(recon, *res["sao_ctb"], sao_tile, bit_depth)
    # Crop the conformance-window pad; levels and modes keep the padded
    # block geometry (the decoder derives it from the SPS dimensions).
    res["recon"] = recon[:, :h, :w]
    return res


def _entry(out: dict, i: int) -> dict:
    """Batch entry i of a batched output dict."""
    return {k: tuple(x[i] for x in v) if isinstance(v, tuple) else v[i]
            for k, v in out.items()}


def encode_plane_closed_loop(plane: torch.Tensor, qp: int, **kwargs) -> dict:
    """Single-plane wavefront encode; see encode_planes_closed_loop.

    Returns {"recon" (H, W), "levels" (nb, N*N), "modes" (nb,)}, and
    the plane's "sao" or "sao_ctb" parameters where asked: the (modes,
    levels) pair and those are all `decode_plane` needs to reconstruct.
    """
    return _entry(encode_planes_closed_loop(plane[None], qp, **kwargs), 0)


def _planes_of(frame: Frame):
    return (("Y", frame.y), ("U", frame.u), ("V", frame.v))


def plane_args(config, is_luma: bool) -> dict:
    """`encode_planes_closed_loop` keywords of one plane of a frame
    under `config` (an `EncoderConfig`), as the JAX package derives
    them: chroma at half the block size (at least 4), with its own mode
    set, DST at 4x4 luma, smoothing on luma only, RDOQ and the filters as
    configured (chroma's deblocking filter on the chroma planes)."""
    bs = config.block_size if is_luma else config.chroma_block_size()
    return dict(
        n=bs,
        mode_set=config.mode_set if is_luma else config.chroma_modes(),
        decision=config.decision,
        use_dst=config.use_dst(bs, is_luma),
        bit_depth=config.bit_depth,
        scan=config.scan,
        dequant_rescale=config.dequant_rescale,
        intra_smoothing=config.intra_smoothing and is_luma,
        deblock=config.deblock,
        deblock_chroma=not is_luma,
        sao=config.sao,
        sao_ctb=config.sao_ctb,
        sao_tile=config.sao_tile,
        rdoq=config.rdoq,
    )


def _upload_frame(frame: Frame, dev: torch.device) -> tuple:
    """The frame's planes on `dev` as int32: (Y (H, W), U and V stacked
    (2, H/2, W/2)).  The three planes are staged in one host tensor in
    their own dtype (pinned where `dev` is a card), copied to the device
    once without blocking, and widened there."""
    y, u, v = frame.y.data, frame.u.data, frame.v.data
    dtype = torch.from_numpy(np.empty(0, np.result_type(y, u, v))).dtype
    host = torch.empty(y.size + u.size + v.size, dtype=dtype,
                       pin_memory=dev.type == "cuda")
    flat = host.numpy()
    for part, plane in zip(np.split(flat, [y.size, y.size + u.size]),
                           (y, u, v)):
        part.reshape(plane.shape)[...] = plane
    count("frame.bytes_up", host.nbytes)
    sent = host.to(dev, non_blocking=True)
    return (sent[:y.size].view(y.shape).to(torch.int32),
            sent[y.size:].view((2,) + u.shape).to(torch.int32))


def _stage_down(t):
    """A device tensor (or tuple of them) copied, without blocking, into
    a new host tensor: pinned on a card, so that the copy is
    asynchronous, from torch's caching host allocator, so that a call
    after the first allocates none."""
    if isinstance(t, tuple):
        return tuple(_stage_down(a) for a in t)
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")
    count("frame.bytes_down", host.nbytes)
    return host.copy_(t, non_blocking=True)


def _send_down(out: dict, dev: torch.device) -> tuple:
    """One plane batch's outputs copied into host staging, enqueued
    after its launches without blocking, the recon narrowed to int16 on
    the device first (it is clipped to the bit depth): (the staging, the
    event after the copies on a card, else None)."""
    narrowed = dict(out, recon=out["recon"].to(torch.int16))
    staged = {k: _stage_down(v) for k, v in narrowed.items()}
    done = None
    if dev.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
    return staged, done


def _take(staged: dict, done) -> dict:
    """Wait for one plane batch's copies, then its outputs as arrays of
    their own: the staging goes back to the allocator's pool when the
    call returns."""
    with span("frame.fetch"):
        if done is not None:
            done.synchronize()
        count("frame.waits", 1)
    with span("frame.convert"):
        return {k: _owned(v) for k, v in staged.items()}


def _owned(h):
    """Host tensor(s) as numpy arrays that own their memory."""
    if isinstance(h, tuple):
        return tuple(_owned(a) for a in h)
    return h.numpy().copy()


def encode_frame_closed_loop(frame: Frame, config, *,
                             device: str | torch.device = "cuda") -> tuple:
    """Closed-loop encode of a Frame -> (recon Frame, bitstream bytes).

    `config` is an `EncoderConfig`.  The bitstream decodes to the recon
    pixel for pixel through `decode_frame`; it carries each plane's SAO
    or CTB-SAO parameters in a SAO NAL.

    One round trip to the device a call: the planes go up in one copy
    in their own dtype; luma is one `encode_plane_closed_loop` call and
    the two chroma planes, which share a shape and every argument, one
    `encode_planes_closed_loop` batch; each batch's outputs come back
    into host staging right after its launches, and every launch and
    copy is enqueued before the host first waits.  The host takes
    luma's outputs while the chroma batch runs, then the chroma pair's.
    What the call returns or hands the bitstream writer is its own,
    never a view of staging.

    While a torch profiler records, the upload is the span
    "frame.upload" of `utils.tracing`, once a call; each plane batch's
    wait for the card is a "frame.fetch" span and its copy out of
    staging a "frame.convert" span, twice a call.  The bytes sent and
    brought back are counted as "frame.bytes_up" and "frame.bytes_down",
    and the host's waits for the card as "frame.waits".
    """
    from nanohevc_tpu_torch.runtime.bitstream import assemble_bitstream

    dev = resolve_device(device)
    luma, chroma = plane_args(config, True), plane_args(config, False)
    with span("frame.upload"):
        y, uv = _upload_frame(frame, dev)
    luma_down = _send_down(encode_plane_closed_loop(y, config.qp, **luma), dev)
    chroma_down = _send_down(
        encode_planes_closed_loop(uv, config.qp, **chroma), dev)
    got_y = _take(*luma_down)
    got_c = _take(*chroma_down)
    got = {"Y": got_y, "U": _entry(got_c, 0), "V": _entry(got_c, 1)}
    recon = Frame(*(Plane(got[p]["recon"]) for p in "YUV"))
    plane_levels, plane_modes, sao, sao_ctb = {}, {}, {}, {}
    for name, g in got.items():
        n = (luma if name == "Y" else chroma)["n"]
        plane_levels[name] = (g["levels"], n)
        plane_modes[name] = g["modes"]
        if config.sao:
            t, pos, offs = g["sao"]
            sao[name] = (int(t), int(pos), offs)
        if config.sao_ctb:
            sao_ctb[name] = (config.sao_tile,) + g["sao_ctb"]
    bitstream = assemble_bitstream(
        frame.width, frame.height, config.qp, plane_levels, plane_modes,
        bit_depth=config.bit_depth, scan=config.scan,
        dequant_rescale=config.dequant_rescale,
        intra_smoothing=config.intra_smoothing,
        entropy_coder=config.entropy_coder,
        deblock=config.deblock,
        sao=sao if config.sao else None,
        sao_ctb=sao_ctb if config.sao_ctb else None,
    )
    return recon, bitstream


def decode_frame(bitstream: bytes, *,
                 device: str | torch.device = "cuda") -> Frame:
    """Pixel-exact decode of a single-frame closed-loop bitstream.

    Geometry, QP, bit depth, scan order and the dequant-rescale and
    smoothing flags come from the stream's parameter sets; each slice
    header carries its plane's block size (and may override the QP).
    """
    from nanohevc_tpu_torch.runtime.bitstream import _SCAN_NAME, parse_bitstream
    from nanohevc_tpu_torch.runtime.entropy import CorruptBitstreamError

    dev = resolve_device(device)
    parsed = parse_bitstream(bitstream)
    params = parsed.get("params", {})
    if not {"width", "height", "qp"} <= params.keys():
        raise CorruptBitstreamError(
            "no usable SPS/PPS in stream (not a nanohevc bitstream, or "
            "parameter sets corrupted)"
        )
    width, height, qp = params["width"], params["height"], params["qp"]
    bit_depth = 8 + params.get("bit_depth_luma_minus8", 0)
    scan = _SCAN_NAME[params.get("scan_idx", 0)]
    rescale = params.get("dequant_rescale", False)
    smoothing = params.get("intra_smoothing", False)
    deblock = params.get("deblock", False)
    sao_all = params.get("sao") or {}
    sao_ctb_all = params.get("sao_ctb") or {}
    if params.get("sao_enabled") and not (sao_all or sao_ctb_all):
        # The PPS promised per-frame SAO parameters; a stream that lost
        # its SAO NAL must fail loudly, not decode silently unfiltered.
        raise CorruptBitstreamError(
            "PPS signals SAO but the frame's SAO NAL is missing "
            "(truncated or corrupted stream)"
        )
    missing = {"Y", "U", "V"} - parsed.keys()
    if missing:
        raise CorruptBitstreamError(
            f"stream is missing plane slices: {sorted(missing)} "
            "(truncated, or slice NALs corrupted)"
        )
    recon = Frame.zeros(height, width, dtype=np.int16)
    for name, dst in _planes_of(recon):
        sl = parsed[name]
        bs = sl["block_size"]
        plane = decode_plane(
            torch.from_numpy(np.ascontiguousarray(sl["levels"])).to(dev),
            torch.from_numpy(np.ascontiguousarray(sl["modes"])).to(dev),
            sl.get("qp", qp),                # slice qp overrides the PPS
            n=bs,
            height=dst.data.shape[0],
            width=dst.data.shape[1],
            use_dst=name == "Y" and bs == 4,
            bit_depth=bit_depth,
            scan=scan,
            dequant_rescale=rescale,
            intra_smoothing=smoothing and name == "Y",   # spec: luma only
            deblock=deblock,
            is_chroma=name != "Y",
            sao=sao_all.get(name),
            sao_ctb=sao_ctb_all.get(name),
        )
        dst.data[...] = plane.cpu().numpy().astype(np.int16)
    return recon


def decode_residual(levels: torch.Tensor, modes: torch.Tensor, qps, *,
                    n: int, hp: int, wp: int, use_dst: bool = False,
                    scan: str = "diag",
                    dequant_rescale: bool = False) -> torch.Tensor:
    """(B, nb, N*N) scan-packed levels, (B, nb) modes and B per-frame QPs
    of the block-aligned (Hp, Wp) geometry -> (B, Hp, Wp) int32 residual
    planes: each frame unpacked, dequantized at its QP and
    inverse-transformed, all its blocks at once."""
    b = levels.shape[0]
    if not b:
        return torch.zeros((0, hp, wp), dtype=torch.int32,
                           device=levels.device)
    res = torch.stack([
        ops.inverse_transform(ops.dequantize(
            ops.scan_unpack(levels[i], scan, modes=modes[i]), int(q), n,
            rescale=dequant_rescale), use_dst)
        for i, q in enumerate(qps)
    ]).reshape(b, hp // n, wp // n, n, n)
    return res.permute(0, 1, 3, 2, 4).reshape(b, hp, wp)


def decode_planes(levels: torch.Tensor, modes: torch.Tensor, qps, *, n: int,
                  height: int, width: int, use_dst: bool = False,
                  bit_depth: int = 8, scan: str = "diag",
                  dequant_rescale: bool = False, intra_smoothing: bool = False,
                  deblock: bool = False, is_chroma: bool = False, sao=None,
                  sao_ctb=None) -> torch.Tensor:
    """Batched decode_plane: (B, nb, N*N) levels, (B, nb) modes and B
    per-frame QPs -> (B, H, W) int32 reconstructions, on the device of
    `levels`.  Each frame's residual is dequantized at its QP and
    inverse-transformed, all its blocks at once; then
    `kernels.decode.decode_blocks` predicts, adds and clips every block
    of the B frames in one call (on the card, one persistent kernel
    launch).

    Then the filters (`kernels.loop_filter`; on the card one launch
    each), on the padded recon: deblocking at each frame's QP (chroma's
    filter with is_chroma), and sao, a
    per-frame ((B,) type, (B,) band_pos, (B, 4) offsets) triple, or
    sao_ctb, (tile, (B, nty, ntx) type, (B, nty, ntx) band, (B, nty,
    ntx, 4) offset maps); arrays from the stream or tensors.
    """
    if sao is not None and sao_ctb is not None:
        raise ValueError("pass per-frame sao OR sao_ctb, not both")
    hp, wp = -(-height // n) * n, -(-width // n) * n
    b = levels.shape[0]
    dev = levels.device
    res = decode_residual(levels, modes, qps, n=n, hp=hp, wp=wp,
                          use_dst=use_dst, scan=scan,
                          dequant_rescale=dequant_rescale)
    modes = modes.reshape(b, (hp // n) * (wp // n)).to(torch.int32)
    recon = decode_blocks(res, modes.contiguous(), n, bit_depth=bit_depth,
                          intra_smoothing=intra_smoothing)
    if deblock:
        recon = deblock_planes(
            recon, torch.tensor([int(q) for q in qps], device=dev),
            bit_depth=bit_depth, is_chroma=is_chroma)
    if sao is not None:
        recon = sao_apply(recon, *sao, bit_depth=bit_depth)
    if sao_ctb is not None:
        recon = sao_apply(recon, *sao_ctb[1:], sao_ctb[0], bit_depth)
    return recon[:, :height, :width]


def decode_plane(levels: torch.Tensor, modes: torch.Tensor, qp: int, *,
                 n: int, height: int, width: int, **kwargs) -> torch.Tensor:
    """Pixel-exact decoder of one closed-loop plane.

    (nb, N*N) scan-packed levels + (nb,) modes -> (H, W) int32 recon,
    by the encoder's wavefront: dequantize and inverse-transform the
    residual, predict each diagonal from the already-reconstructed
    neighbours, add, clip, filter.  A non-aligned geometry decodes the
    padded one and crops back.  Keywords as `decode_planes`, with sao
    the plane's (type, band_pos, offsets[4]) and sao_ctb its (tile,
    type map, band map, offset map).
    """
    sao, sao_ctb = kwargs.pop("sao", None), kwargs.pop("sao_ctb", None)
    if sao is not None:
        sao = tuple(torch.as_tensor(a)[None] for a in sao)
    if sao_ctb is not None:
        sao_ctb = (sao_ctb[0],) + tuple(torch.as_tensor(a)[None]
                                        for a in sao_ctb[1:])
    return decode_planes(levels[None], modes[None], [qp], n=n, height=height,
                         width=width, sao=sao, sao_ctb=sao_ctb, **kwargs)[0]
