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

Routing (`encode_planes_closed_loop`):

- DC/planar by energy and the 35-mode SATD search go to the
  hand-written CUDA kernel `kernels.wavefront.wavefront_encode_planes`
  (the port of K4 and of K3a/K3b) at every batch size.  The JAX
  package sends DC/planar at batch >= 2 to its XLA scan instead
  (models/wavefront.py:307-321 there), a TPU timing choice: both of
  its paths give the same outputs bit for bit, and so does this one.
- Other mode sets and decisions, luma reference smoothing, and
  `allow_fast=False` run the plain loop
  `kernels.wavefront.wavefront_encode_planes_reference`.
- The JAX package's skew tables and skewed boundary buffers are a TPU
  device for avoiding gathers and scatters; the plain loop gathers and
  scatters the diagonal's blocks directly.  `kernel_split` and
  `unroll` are TPU layout knobs and are not taken.
- `decision="rd"`, RDOQ, deblocking and SAO are not ported yet and
  raise NotImplementedError.

Non-block-aligned planes are padded by edge replication and the recon
cropped back (the conformance window), so `decode_plane` reproduces
the encoder's reconstruction pixel for pixel at any geometry.  The
decoder runs the same diagonal loop with `ops.predict_by_mode_mm`, in
plain PyTorch on the device of its inputs (the JAX decoder runs no
Pallas kernel either).
"""

from __future__ import annotations

import numpy as np
import torch

from nanohevc_tpu_torch import ops, resolve_device
from nanohevc_tpu_torch.frame import Frame
from nanohevc_tpu_torch.kernels.wavefront import (
    diagonal_blocks,
    wavefront_encode_planes,
    wavefront_encode_planes_reference,
    wavefront_supported,
)


def _refuse(decision: str = "energy", rdoq: bool = False,
            deblock: bool = False, sao: bool = False,
            sao_ctb: bool = False) -> None:
    for flag, on in (('decision="rd"', decision == "rd"), ("rdoq", rdoq),
                     ("deblock", deblock), ("sao", sao),
                     ("sao_ctb", sao_ctb)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to the closed loop yet")


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
    sao: bool = False,
    sao_ctb: bool = False,
    rdoq: bool = False,
    allow_fast: bool | None = None,
) -> dict:
    """Batched wavefront encode of (B, H, W) planes, reconstruction-fed.

    Returns {"recon" (B, H, W) int32, "levels" (B, nb, N*N) int32
    scan-packed in raster block order, "modes" (B, nb) int32} on the
    planes' device; nb counts the blocks of the padded geometry.  qp is
    a Python int.  allow_fast=None takes the kernel where it applies
    (see the module docstring); False forces the plain loop; True
    requires the kernel.
    """
    _refuse(decision, rdoq, deblock, sao, sao_ctb)
    b, h, w = planes.shape
    src = pad_to_blocks(planes.to(torch.int32), n)
    fits = wavefront_supported(n, mode_set, decision, use_dst)
    if allow_fast is None:
        allow_fast = fits and not intra_smoothing
    elif allow_fast and (not fits or intra_smoothing):
        raise ValueError(
            f"the wavefront kernel does not cover n={n}, mode_set="
            f"{mode_set!r}, decision={decision!r}, use_dst={use_dst}, "
            f"intra_smoothing={intra_smoothing}")
    kw = dict(mode_set=mode_set, decision=decision, bit_depth=bit_depth,
              use_dst=use_dst, dequant_rescale=dequant_rescale)
    if allow_fast:
        out = wavefront_encode_planes(src, int(qp), n, **kw)
    else:
        out = wavefront_encode_planes_reference(
            src, int(qp), n, intra_smoothing=intra_smoothing, **kw)
    nb = out["modes"].shape[1]
    levels = ops.scan_pack(out["levels"].reshape(b * nb, n, n), scan,
                           modes=out["modes"].reshape(b * nb))
    return {"recon": out["recon"][:, :h, :w],
            "levels": levels.reshape(b, nb, n * n),
            "modes": out["modes"]}


def encode_plane_closed_loop(plane: torch.Tensor, qp: int, **kwargs) -> dict:
    """Single-plane wavefront encode; see encode_planes_closed_loop.

    Returns {"recon" (H, W), "levels" (nb, N*N), "modes" (nb,)}: the
    (modes, levels) pair is all `decode_plane` needs to reconstruct.
    """
    out = encode_planes_closed_loop(plane[None], qp, **kwargs)
    return {k: v[0] for k, v in out.items()}


def _planes_of(frame: Frame):
    return (("Y", frame.y), ("U", frame.u), ("V", frame.v))


def plane_args(config, is_luma: bool) -> dict:
    """`encode_planes_closed_loop` keywords of one plane of a frame
    under `config` (an `EncoderConfig`), as the JAX package derives
    them: chroma at half the block size (at least 4), with its own mode
    set, DST at 4x4 luma, smoothing on luma only."""
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
    )


def encode_frame_closed_loop(frame: Frame, config, *,
                             device: str | torch.device = "cuda") -> tuple:
    """Closed-loop encode of a Frame -> (recon Frame, bitstream bytes).

    `config` is an `EncoderConfig`.  The bitstream decodes to the recon
    pixel for pixel through `decode_frame`.
    """
    from nanohevc_tpu_torch.runtime.bitstream import assemble_bitstream

    _refuse(config.decision, config.rdoq, config.deblock, config.sao,
            config.sao_ctb)
    dev = resolve_device(device)
    recon = Frame.zeros(frame.height, frame.width, dtype=np.int16)
    plane_levels, plane_modes = {}, {}
    for (name, src), (_, dst) in zip(_planes_of(frame), _planes_of(recon)):
        args = plane_args(config, name == "Y")
        out = encode_plane_closed_loop(
            torch.from_numpy(src.data.astype(np.int32)).to(dev), config.qp,
            **args)
        dst.data[...] = out["recon"].cpu().numpy().astype(np.int16)
        plane_levels[name] = (out["levels"].cpu().numpy(), args["n"])
        plane_modes[name] = out["modes"].cpu().numpy()
    bitstream = assemble_bitstream(
        frame.width, frame.height, config.qp, plane_levels, plane_modes,
        bit_depth=config.bit_depth, scan=config.scan,
        dequant_rescale=config.dequant_rescale,
        intra_smoothing=config.intra_smoothing,
        entropy_coder=config.entropy_coder,
        deblock=config.deblock,
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
    if params.get("sao_enabled") and not (params.get("sao")
                                          or params.get("sao_ctb")):
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
    _refuse(deblock=params.get("deblock", False),
            sao=bool(params.get("sao")), sao_ctb=bool(params.get("sao_ctb")))
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
        )
        dst.data[...] = plane.cpu().numpy().astype(np.int16)
    return recon


def decode_planes(levels: torch.Tensor, modes: torch.Tensor, qps, *, n: int,
                  height: int, width: int, use_dst: bool = False,
                  bit_depth: int = 8, scan: str = "diag",
                  dequant_rescale: bool = False, intra_smoothing: bool = False,
                  deblock: bool = False, sao=None,
                  sao_ctb=None) -> torch.Tensor:
    """Batched decode_plane: (B, nb, N*N) levels, (B, nb) modes and B
    per-frame QPs -> (B, H, W) int32 reconstructions, on the device of
    `levels`.  The B frames' diagonals are decoded together."""
    _refuse(deblock=deblock, sao=sao is not None, sao_ctb=sao_ctb is not None)
    hp, wp = -(-height // n) * n, -(-width // n) * n
    nby, nbx = hp // n, wp // n
    b = levels.shape[0]
    dev = levels.device
    res = torch.stack([
        ops.inverse_transform(ops.dequantize(
            ops.scan_unpack(levels[i], scan, modes=modes[i]), int(q), n,
            rescale=dequant_rescale), use_dst)
        for i, q in enumerate(qps)
    ]).reshape(b, nby, nbx, n, n) if b else levels.new_zeros((0, nby, nbx, n, n))
    modes = modes.reshape(b, nby, nbx)
    recon = torch.zeros((b, hp, wp), dtype=torch.int32, device=dev)
    rec_blocks = recon.view(b, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
    boundary = 1 << (bit_depth - 1)
    for d in range(nby + nbx - 1):
        by, bx = diagonal_blocks(d, nby, nbx, dev)
        m = by.shape[0]
        refs = ops.extract_refs_at(recon, by, bx, n, boundary)
        pred = ops.predict_by_mode_mm(
            refs.reshape(b * m, 4 * n + 2), n, modes[:, by, bx].reshape(b * m),
            smoothing=intra_smoothing, bit_depth=bit_depth)
        rec = (pred + res[:, by, bx].reshape(b * m, n, n)).clamp(
            0, (1 << bit_depth) - 1)
        rec_blocks[:, by, bx] = rec.reshape(b, m, n, n)
    return recon[:, :height, :width]


def decode_plane(levels: torch.Tensor, modes: torch.Tensor, qp: int, *,
                 n: int, height: int, width: int, **kwargs) -> torch.Tensor:
    """Pixel-exact decoder of one closed-loop plane.

    (nb, N*N) scan-packed levels + (nb,) modes -> (H, W) int32 recon,
    by the encoder's wavefront: dequantize and inverse-transform the
    residual, predict each diagonal from the already-reconstructed
    neighbours, add, clip.  A non-aligned geometry decodes the padded
    one and crops back.  Keywords as `decode_planes`.
    """
    return decode_planes(levels[None], modes[None], [qp], n=n, height=height,
                         width=width, **kwargs)[0]
