"""Closed-loop decode of a batch of planes: CUDA kernel wrapper and its
plain PyTorch version.

No TPU kernel stands behind it: the JAX package decodes a batch of
planes as one compiled program, a `jax.lax.scan` over the
anti-diagonals vmapped over the batch
(`nanohevc_tpu.models.wavefront.decode_planes`, the scan in
`decode_plane`).  The kernel, `csrc/decode.cu`, is the port's
counterpart of that single dispatch: one persistent launch per call, a
team of 1, 2 or 4 warps a block row, groups of W block rows a thread
block, tagged words for the hand-offs between rows; its header says how
it is laid out and what bounds it.

Both versions take the residual already dequantized and
inverse-transformed, as (B, Hp, Wp) block-aligned int32 planes, and the
(B, nb) int32 modes (HEVC numbering) in raster block order, and return
the (B, Hp, Wp) int32 reconstruction: each block predicted by its mode
from the closed loop's references (`ops.extract_refs_at` on a
zero-filled recon written one anti-diagonal at a time), with luma
reference smoothing where asked, plus the residual, clipped to the bit
depth.  The plain version walks the anti-diagonals; the kernel decodes
block row by block row, writing the availability rule's extensions
instead of reading them, which gives the same pixels.

`decode_blocks` dispatches on the device of its input: a CPU tensor
goes to `decode_blocks_reference`, a CUDA tensor to the kernel (or an
exception).  There is no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels.mode_search import angle_table
from nanohevc_tpu_torch.kernels.slab_pipeline import BLOCK_SIZES, transform_table
from nanohevc_tpu_torch.kernels.wavefront import diagonal_blocks, filter_mask


def decode_blocks_reference(residual: torch.Tensor, modes: torch.Tensor,
                            n: int, *, bit_depth: int = 8,
                            intra_smoothing: bool = False) -> torch.Tensor:
    """Plain PyTorch decode, on the input's device: (B, Hp, Wp)
    residual planes and (B, nb) modes -> (B, Hp, Wp) int32 recon.

    A loop over anti-diagonals on a zero-filled recon plane:
    `extract_refs_at` for the diagonal's blocks of every plane,
    `predict_by_mode_mm` by their modes (smoothing included), the
    residual added, the sum clipped, the blocks written back.
    """
    b, hp, wp = residual.shape
    nby, nbx = hp // n, wp // n
    dev = residual.device
    res = residual.reshape(b, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
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
    return recon


@lru_cache(maxsize=None)
def cuda_kernels():
    """Build (at first use) and load this kernel's CUDA library."""
    from nanohevc_tpu_torch.kernels.build import KernelLibrary

    return KernelLibrary("decode",
                         np.concatenate([transform_table(), angle_table()]))


def _validate(residual: torch.Tensor, modes: torch.Tensor, n: int,
              bit_depth: int) -> None:
    what = "decode_blocks"
    if not isinstance(residual, torch.Tensor) or residual.dim() != 3:
        raise ValueError(f"{what} needs a 3-D (B, H, W) residual tensor")
    if residual.dtype != torch.int32:
        raise TypeError(f"{what} needs an int32 residual, got "
                        f"{residual.dtype}")
    if not residual.is_contiguous():
        raise ValueError(f"{what} needs a contiguous residual")
    if n not in BLOCK_SIZES:
        raise ValueError(f"{what} does not cover n={n}")
    b, hp, wp = residual.shape
    if hp % n or wp % n:
        raise ValueError(f"{what} needs block-aligned planes, got "
                         f"{(hp, wp)} at N={n}")
    nb = (hp // n) * (wp // n)
    if not isinstance(modes, torch.Tensor) or tuple(modes.shape) != (b, nb):
        raise ValueError(f"{what} needs (B, nb) = {(b, nb)} modes")
    if modes.dtype != torch.int32:
        raise TypeError(f"{what} needs int32 modes, got {modes.dtype}")
    if not modes.is_contiguous():
        raise ValueError(f"{what} needs contiguous modes")
    if modes.device != residual.device:
        raise ValueError(f"{what} needs the modes on the residual's device, "
                         f"got {modes.device} and {residual.device}")
    if not 1 <= bit_depth <= 16:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    if residual.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {residual.device}")
    # On the card the range check would cost a host synchronise; the
    # kernel reads an out-of-range mode as the plain version does.
    if residual.device.type == "cpu" and modes.numel() and (
            int(modes.min()) < 0 or int(modes.max()) > 34):
        raise ValueError(f"{what} needs modes in 0..34")


def group_rows(n: int, hp: int, wp: int, device: int, lib=None) -> int:
    """W, the block rows a thread block decodes together, for (Hp, Wp)
    planes at block size n on card `device`, as the kernel's library
    (`lib`, this package's by default) chooses it (csrc/decode.cu,
    point 2)."""
    lib = lib or cuda_kernels().lib
    rows = lib.nhv_decode_group_rows(n, hp, wp, device)
    if rows < 1:
        raise RuntimeError(f"nhv_decode_group_rows failed: CUDA error "
                           f"{-rows}")
    return rows


def work_ints(batch: int, hp: int, wp: int, n: int, rows: int) -> int:
    """Zeroed int32 words the kernel needs at W = rows: the ticket
    counter, then the edge buffer, a line of Wp words after each group
    of rows of each plane but the last."""
    groups = -(-(hp // n) // rows)
    return 1 + batch * (groups - 1) * wp


def _launch(lib, residual: torch.Tensor, modes: torch.Tensor, n: int, *,
            bit_depth: int = 8, intra_smoothing: bool = False, rows: int = 0,
            max_grid: int = 0) -> tuple[torch.Tensor, int]:
    """One launch of `lib`'s nhv_wavefront_decode (this package's
    library, or a tool's build of an edited copy, whose constant table
    is set) on the current stream, at W = rows (0: the library's
    choice) and a grid of at most max_grid (0: no cap): (recon, grids
    launched)."""
    b, hp, wp = residual.shape
    dev = residual.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    rows = rows or group_rows(n, hp, wp, index, lib)
    recon = torch.empty_like(residual)     # the kernel writes every pixel
    smooth = intra_smoothing and n > 4
    # the strong filter's flatness threshold (N = 32 only), computed as
    # the plain version computes it
    thresh = 1 << (bit_depth - 5) if smooth and n == 32 else 0
    work = torch.zeros(work_ints(b, hp, wp, n, rows), dtype=torch.int32,
                       device=dev)
    grids = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.nhv_wavefront_decode(
        residual.data_ptr(), modes.data_ptr(), b, hp, wp, n, bit_depth,
        thresh, filter_mask(n, smooth), rows, max_grid,
        recon.data_ptr(), work.data_ptr(), ctypes.addressof(grids), stream,
        index,
    )
    if rc != 0:
        raise RuntimeError(f"nhv_wavefront_decode failed: CUDA error {rc}")
    return recon, grids.value


def decode_blocks(residual: torch.Tensor, modes: torch.Tensor, n: int, *,
                  bit_depth: int = 8, intra_smoothing: bool = False,
                  _max_grid: int = 0) -> torch.Tensor:
    """(B, Hp, Wp) block-aligned int32 residual planes and (B, nb) int32
    modes -> (B, Hp, Wp) int32 recon, as `decode_blocks_reference`
    describes.

    On a CUDA tensor this runs the hand-written kernel, one persistent
    grid launch per call, on the current stream (no synchronisation),
    adds one to `decode_blocks.launches` and the grids the C call
    launched to `decode_blocks.grids`; on a CPU tensor it runs the plain
    version.  `_max_grid`, a cap on the grid (0: none), is for the
    tests of the kernel's schedule on small grids.
    """
    _validate(residual, modes, n, bit_depth)
    if residual.device.type == "cpu":
        return decode_blocks_reference(residual, modes, n, bit_depth=bit_depth,
                                       intra_smoothing=intra_smoothing)
    if residual.numel() == 0:
        return torch.empty_like(residual)
    dev = residual.device
    kern = cuda_kernels()
    kern.ensure_tables(dev.index if dev.index is not None
                       else torch.cuda.current_device())
    recon, grids = _launch(kern.lib, residual, modes, n, bit_depth=bit_depth,
                           intra_smoothing=intra_smoothing,
                           max_grid=_max_grid)
    decode_blocks.launches += 1
    decode_blocks.grids += grids
    return recon


decode_blocks.launches = 0
decode_blocks.grids = 0
