"""Open-loop 35-mode SATD search and full pipeline of one plane: CUDA
kernel wrapper and its plain PyTorch version.

Port of the two TPU kernels that compute it,
`nanohevc_tpu/kernels/mode_search_slab.py` (`mode_search_encode_plane`,
N 16/32 there) and `nanohevc_tpu/kernels/mode_search_grouped.py`
(`mode_search_encode_plane_grouped`, N 4/8 there), as reached through
`mode_search_encode_plane_auto`.  One kernel, `csrc/mode_search.cu`,
serves every N; its header says how it is laid out and what bounds it.

The decision is `decide_modes(mode_set="all", decision="satd")`:
planar, DC and angular 2..34 over source-fed references, Sylvester
Walsh-Hadamard SATD, ties to the lowest mode index; then the slab
kernel's transform-quantize tail.  Outputs follow the slab kernel's
contract: recon (H, W), levels (nb, N, N) raster blocks, modes (nb,)
int32 in HEVC numbering, rows below the last full block-row passed
through from the source.

`mode_search_encode_plane` dispatches on the device of its input: a
CPU tensor goes to `mode_search_encode_plane_reference`, a CUDA tensor
to the kernel (or an exception).  There is no fallback.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from nanohevc_tpu_torch.tables import INTRA_PRED_ANGLE, INV_ANGLE
from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels.slab_pipeline import (
    BLOCK_SIZES,
    encode_tail_reference,
    launch_encode,
    transform_table,
    validate_plane,
)


def mode_search_supported(n: int, width: int) -> bool:
    """Whether the kernel covers this block size and plane width."""
    return n in BLOCK_SIZES and width % n == 0


def mode_search_encode_plane_reference(plane: torch.Tensor, qp: int, n: int, *,
                                       bit_depth: int = 8, use_dst: bool = False,
                                       dequant_rescale: bool = False) -> dict:
    """Plain PyTorch version of the kernel, on the input's device.

    (H, W) -> dict(recon (H, W) int32, levels (nb, N, N) int32 raster
    blocks, modes (nb,) int32).  Rows below the last full block-row pass
    through to recon unchanged.
    """
    # models.all_intra routes planes to this module, so its mode
    # decision is imported at call time.
    from nanohevc_tpu_torch.models.all_intra import decide_modes

    src = plane.to(torch.int32)
    blocks = ops.tile_plane(src, n)
    refs = ops.extract_refs(src, n, boundary=1 << (bit_depth - 1))
    pred, modes = decide_modes(blocks, refs, n, "all", "satd",
                               bit_depth=bit_depth)
    return encode_tail_reference(src, blocks, pred, modes, qp, n,
                                 bit_depth=bit_depth, use_dst=use_dst,
                                 dequant_rescale=dequant_rescale)


def angle_table() -> np.ndarray:
    """intraPredAngle of modes 2..34, then invAngle (0 where the angle
    is not negative): the 66 ints after the transforms in the kernel's
    constant table."""
    inv = [INV_ANGLE.get(a, 0) for a in INTRA_PRED_ANGLE]
    return np.asarray(list(INTRA_PRED_ANGLE) + inv, np.int32)


@lru_cache(maxsize=None)
def cuda_kernels():
    """Build (at first use) and load this kernel's CUDA library."""
    from nanohevc_tpu_torch.kernels.build import KernelLibrary

    return KernelLibrary("mode_search",
                         np.concatenate([transform_table(), angle_table()]))


def mode_search_encode_plane(plane: torch.Tensor, qp: int, n: int, *,
                             bit_depth: int = 8, use_dst: bool = False,
                             dequant_rescale: bool = False) -> dict:
    """(H, W) int32 plane -> dict(recon, levels, modes), as
    `mode_search_encode_plane_reference` describes.

    qp is a static Python int.  On a CUDA tensor this launches the
    hand-written kernel on the current stream (no synchronisation) and
    adds one to `mode_search_encode_plane.launches`; on a CPU tensor it
    runs the plain version.
    """
    validate_plane("mode_search_encode_plane", plane, n, use_dst, bit_depth)
    kw = dict(bit_depth=bit_depth, use_dst=use_dst,
              dequant_rescale=dequant_rescale)
    if plane.device.type == "cpu":
        return mode_search_encode_plane_reference(plane, qp, n, **kw)
    out = launch_encode(cuda_kernels(), "nhv_mode_search_encode", plane, qp,
                        n, **kw)
    if out["modes"].numel():
        mode_search_encode_plane.launches += 1
    return out


mode_search_encode_plane.launches = 0
