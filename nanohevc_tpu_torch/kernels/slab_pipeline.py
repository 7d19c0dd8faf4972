"""Open-loop DC/planar full pipeline of one plane: CUDA kernel wrapper
and its plain PyTorch version.

Port of the TPU kernel `nanohevc_tpu/kernels/slab_pipeline.py`
(`slab_encode_plane`).  The kernel is `csrc/slab_pipeline.cu`; its
header says how it is laid out and what bounds it.  Unlike the TPU
kernel, whose levels and modes came out in slab layout, this one
writes levels as (nb, N, N) raster blocks and one mode per block.

`slab_encode_plane` dispatches on the device of its input: a CPU
tensor goes to `slab_encode_plane_reference`, a CUDA tensor to the
kernel (or an exception).  There is no fallback from one to the other.

The checks, the transform-quantize tail and the launch are shared with
`kernels.mode_search`, whose kernel has the same output contract.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from nanohevc_tpu_torch.tables import transform_matrix
from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.ops.intra import DC_MODE, PLANAR_MODE
from nanohevc_tpu_torch.params import qp_scalars

BLOCK_SIZES = (4, 8, 16, 32)

# Order of the transform matrices in the kernels' constant tables.
_TABLE_ORDER = ((4, False), (8, False), (16, False), (32, False), (4, True))


def slab_supported(n: int, width: int) -> bool:
    """Whether the kernel covers this block size and plane width."""
    return n in BLOCK_SIZES and width % n == 0


def validate_plane(what: str, plane: torch.Tensor, n: int, use_dst: bool,
                   bit_depth: int) -> None:
    """Raise on an input that the encode kernels do not take."""
    if not isinstance(plane, torch.Tensor) or plane.dim() != 2:
        raise ValueError(f"{what} needs a 2-D (H, W) tensor")
    if plane.dtype != torch.int32:
        raise TypeError(f"{what} needs int32, got {plane.dtype}")
    if not plane.is_contiguous():
        raise ValueError(f"{what} needs a contiguous plane")
    if n not in BLOCK_SIZES:
        raise ValueError(f"unsupported block size: {n}")
    if plane.shape[1] % n:
        raise ValueError(
            f"{what} requires W % N == 0, got {plane.shape[1]} % {n}"
        )
    if use_dst and n != 4:
        raise ValueError("DST-VII is only defined at 4x4")
    if not 1 <= bit_depth <= 16:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    if plane.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {plane.device}")


def slab_encode_plane_reference(plane: torch.Tensor, qp: int, n: int, *,
                                bit_depth: int = 8, use_dst: bool = False,
                                dequant_rescale: bool = False) -> dict:
    """Plain PyTorch version of the kernel, on the input's device.

    (H, W) -> dict(recon (H, W) int32, levels (nb, N, N) int32 raster
    blocks, modes (nb,) int32 with 1 = DC and 0 = planar).  Rows below
    the last full block-row pass through to recon unchanged.
    """
    src = plane.to(torch.int32)
    blocks = ops.tile_plane(src, n)
    refs = ops.extract_refs(src, n, boundary=1 << (bit_depth - 1))
    dc = ops.dc_predict(refs, n)
    pl = ops.planar_predict(refs, n)
    dc_wins = (ops.residual_energy_blocks(blocks - dc)
               <= ops.residual_energy_blocks(blocks - pl))
    pred = torch.where(dc_wins[:, None, None], dc, pl)
    modes = torch.where(dc_wins, DC_MODE, PLANAR_MODE).to(torch.int32)
    return encode_tail_reference(src, blocks, pred, modes, qp, n,
                                 bit_depth=bit_depth, use_dst=use_dst,
                                 dequant_rescale=dequant_rescale)


def encode_tail_reference(src: torch.Tensor, blocks: torch.Tensor,
                          pred: torch.Tensor, modes: torch.Tensor, qp: int,
                          n: int, *, bit_depth: int, use_dst: bool,
                          dequant_rescale: bool) -> dict:
    """The tail every encode kernel runs after its mode decision, plain:
    forward transform, quantize, dequantize, inverse transform, clip.

    src (H, W) int32, blocks and pred (nb, N, N), modes (nb,) ->
    dict(recon, levels, modes) in the kernels' output layout.
    """
    h, w = src.shape
    levels = ops.quantize(ops.forward_transform(blocks - pred, use_dst), qp, n)
    rec_res = ops.inverse_transform(
        ops.dequantize(levels, qp, n, rescale=dequant_rescale), use_dst
    )
    recon_blocks = (pred + rec_res).clamp(0, (1 << bit_depth) - 1)
    rows = (h // n) * n
    recon = src.clone()
    recon[:rows] = ops.untile_plane(recon_blocks, rows, w)
    return {"recon": recon, "levels": levels, "modes": modes}


def transform_table() -> np.ndarray:
    """The transform matrices in the kernels' constant-table order."""
    return np.concatenate([
        np.asarray(transform_matrix(m, d), np.int32).ravel()
        for m, d in _TABLE_ORDER
    ])


@lru_cache(maxsize=None)
def cuda_kernels():
    """Build (at first use) and load this kernel's CUDA library."""
    from nanohevc_tpu_torch.kernels.build import KernelLibrary

    return KernelLibrary("slab_pipeline", transform_table())


def launch_encode(kern, entry: str, plane: torch.Tensor, qp: int, n: int, *,
                  bit_depth: int, use_dst: bool, dequant_rescale: bool) -> dict:
    """Launch an encode kernel of `kern` (a `build.KernelLibrary`) on a
    validated CUDA plane; returns its outputs (see the references).

    Allocates the outputs, copies the rows below the last full block-row
    to recon, launches on the current stream without synchronising, and
    raises when the C entry point reports a CUDA error.
    """
    h, w = plane.shape
    nby, nbx = h // n, w // n
    nb = nby * nbx
    dev = plane.device
    recon = torch.empty_like(plane)
    levels = torch.empty((nb, n, n), dtype=torch.int32, device=dev)
    modes = torch.empty((nb,), dtype=torch.int32, device=dev)
    rows = nby * n
    if rows < h:
        recon[rows:] = plane[rows:]
    if nb == 0:
        return {"recon": recon, "levels": levels, "modes": modes}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    kern.ensure_tables(index)
    q = qp_scalars(qp, n, bit_depth, dequant_rescale)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(kern.lib, entry)(
        plane.data_ptr(), h, w, n, int(use_dst), *q,
        recon.data_ptr(), levels.data_ptr(), modes.data_ptr(), stream, index,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return {"recon": recon, "levels": levels, "modes": modes}


def slab_encode_plane(plane: torch.Tensor, qp: int, n: int, *,
                      bit_depth: int = 8, use_dst: bool = False,
                      dequant_rescale: bool = False) -> dict:
    """(H, W) int32 plane -> dict(recon, levels, modes), as
    `slab_encode_plane_reference` describes.

    qp is a static Python int.  On a CUDA tensor this launches the
    hand-written kernel on the current stream (no synchronisation) and
    adds one to `slab_encode_plane.launches`; on a CPU tensor it runs
    the plain version.
    """
    validate_plane("slab_encode_plane", plane, n, use_dst, bit_depth)
    kw = dict(bit_depth=bit_depth, use_dst=use_dst,
              dequant_rescale=dequant_rescale)
    if plane.device.type == "cpu":
        return slab_encode_plane_reference(plane, qp, n, **kw)
    out = launch_encode(cuda_kernels(), "nhv_slab_encode", plane, qp, n, **kw)
    if out["modes"].numel():
        slab_encode_plane.launches += 1
    return out


slab_encode_plane.launches = 0
