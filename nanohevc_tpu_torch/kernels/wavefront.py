"""Closed-loop (wavefront) encode of a batch of planes: CUDA kernel
wrapper and its plain PyTorch version.

Port of the three TPU kernels of the closed loop, as reached through
`nanohevc_tpu.models.wavefront.encode_planes_closed_loop`:

- `nanohevc_tpu/kernels/wavefront_slab.py` (`wavefront_encode_blocks`,
  K4): DC/planar by energy;
- `nanohevc_tpu/kernels/wavefront_mode_slab.py`
  (`wavefront_mode_search_blocks`, K3b) and
  `nanohevc_tpu/kernels/wavefront_mode_grouped.py`
  (`wavefront_mode_search_raster_grouped`, K3a): the 35-mode SATD
  search, which differ only in TPU layout.

One kernel, `csrc/wavefront.cu`, serves all three, templated on the
body and on N; its header says how it is laid out and what bounds it.

Blocks on one anti-diagonal (by + bx == d) depend only on earlier
diagonals, so the encode walks the nby + nbx - 1 diagonals in order
and codes each diagonal's blocks of every plane of the batch at once.
A block's references come from the reconstruction with the clamps of
`ops.extract_refs_at`, which on a zero-filled reconstruction written
one diagonal at a time is the closed loop's availability rule.

`wavefront_encode_planes` dispatches on the device of its input: a
CPU tensor goes to `wavefront_encode_planes_reference`, a CUDA tensor
to the kernel (or an exception).  There is no fallback.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels.mode_search import angle_table
from nanohevc_tpu_torch.kernels.slab_pipeline import BLOCK_SIZES, transform_table
from nanohevc_tpu_torch.params import qp_scalars

# (mode_set, decision) -> the kernel's body: 0 DC/planar by energy,
# 1 the 35-mode SATD search.
BODIES = {("dc_planar", "energy"): 0, ("all", "satd"): 1}


def wavefront_supported(n: int, mode_set: str, decision: str,
                        use_dst: bool) -> bool:
    """Whether the kernel covers this configuration: the union of the
    TPU kernels' checks, without their TPU batch rule."""
    return ((mode_set, decision) in BODIES and n in BLOCK_SIZES
            and (not use_dst or n == 4))


def diagonal_blocks(d: int, nby: int, nbx: int, device) -> tuple:
    """(by, bx) int64 tensors of the blocks on anti-diagonal d, by rising."""
    by = torch.arange(max(0, d - nbx + 1), min(nby, d + 1), device=device)
    return by, d - by


def wavefront_encode_planes_reference(
        planes: torch.Tensor, qp: int, n: int, *,
        mode_set: str = "dc_planar", decision: str = "energy",
        bit_depth: int = 8, use_dst: bool = False,
        dequant_rescale: bool = False,
        intra_smoothing: bool = False) -> dict:
    """Plain PyTorch closed loop, on the input's device.

    (B, Hp, Wp) block-aligned int32 planes -> dict(recon (B, Hp, Wp)
    int32, levels (B, nb, N, N) int32 raster blocks, modes (B, nb)
    int32).  A loop over anti-diagonals on a zero-filled recon plane:
    `extract_refs_at` for the diagonal's blocks, `decide_modes` (any
    mode set and decision it takes, smoothing included), the
    transform-quantize tail, then the blocks written back.
    """
    # models.all_intra imports the kernels' modules, so its mode
    # decision is imported at call time.
    from nanohevc_tpu_torch.models.all_intra import decide_modes

    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    dev = planes.device
    src = planes.to(torch.int32).reshape(b, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
    recon = torch.zeros((b, hp, wp), dtype=torch.int32, device=dev)
    rec_blocks = recon.view(b, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
    levels = torch.empty((b, nby, nbx, n, n), dtype=torch.int32, device=dev)
    modes = torch.empty((b, nby, nbx), dtype=torch.int32, device=dev)
    boundary = 1 << (bit_depth - 1)
    for d in range(nby + nbx - 1):
        by, bx = diagonal_blocks(d, nby, nbx, dev)
        m = by.shape[0]
        blk = src[:, by, bx].reshape(b * m, n, n)
        refs = ops.extract_refs_at(recon, by, bx, n, boundary)
        pred, mode = decide_modes(blk, refs.reshape(b * m, 4 * n + 2), n,
                                  mode_set, decision, smoothing=intra_smoothing,
                                  bit_depth=bit_depth)
        lev = ops.quantize(ops.forward_transform(blk - pred, use_dst), qp, n)
        res = ops.inverse_transform(
            ops.dequantize(lev, qp, n, rescale=dequant_rescale), use_dst)
        rec = (pred + res).clamp(0, (1 << bit_depth) - 1)
        rec_blocks[:, by, bx] = rec.reshape(b, m, n, n)
        levels[:, by, bx] = lev.reshape(b, m, n, n)
        modes[:, by, bx] = mode.reshape(b, m)
    return {"recon": recon, "levels": levels.reshape(b, nby * nbx, n, n),
            "modes": modes.reshape(b, nby * nbx)}


@lru_cache(maxsize=None)
def cuda_kernels():
    """Build (at first use) and load this kernel's CUDA library."""
    from nanohevc_tpu_torch.kernels.build import KernelLibrary

    return KernelLibrary("wavefront",
                         np.concatenate([transform_table(), angle_table()]))


def _validate(planes: torch.Tensor, n: int, mode_set: str, decision: str,
              use_dst: bool, bit_depth: int) -> None:
    what = "wavefront_encode_planes"
    if not isinstance(planes, torch.Tensor) or planes.dim() != 3:
        raise ValueError(f"{what} needs a 3-D (B, H, W) tensor")
    if planes.dtype != torch.int32:
        raise TypeError(f"{what} needs int32, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError(f"{what} needs contiguous planes")
    if not wavefront_supported(n, mode_set, decision, use_dst):
        raise ValueError(
            f"{what} does not cover n={n}, mode_set={mode_set!r}, "
            f"decision={decision!r}, use_dst={use_dst}")
    if planes.shape[1] % n or planes.shape[2] % n:
        raise ValueError(f"{what} needs block-aligned planes, got "
                         f"{tuple(planes.shape[1:])} at N={n}")
    if not 1 <= bit_depth <= 16:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {planes.device}")


def wavefront_encode_planes(planes: torch.Tensor, qp: int, n: int, *,
                            mode_set: str = "dc_planar",
                            decision: str = "energy", bit_depth: int = 8,
                            use_dst: bool = False,
                            dequant_rescale: bool = False) -> dict:
    """(B, Hp, Wp) block-aligned int32 planes -> dict(recon, levels,
    modes), as `wavefront_encode_planes_reference` describes, for the
    configurations `wavefront_supported` admits.

    qp is a static Python int.  On a CUDA tensor this runs the
    hand-written kernel, one launch per anti-diagonal from one C call,
    on the current stream (no synchronisation), and adds one to
    `wavefront_encode_planes.launches`; on a CPU tensor it runs the
    plain version.
    """
    _validate(planes, n, mode_set, decision, use_dst, bit_depth)
    kw = dict(mode_set=mode_set, decision=decision, bit_depth=bit_depth,
              use_dst=use_dst, dequant_rescale=dequant_rescale)
    if planes.device.type == "cpu":
        return wavefront_encode_planes_reference(planes, qp, n, **kw)
    b, hp, wp = planes.shape
    nb = (hp // n) * (wp // n)
    dev = planes.device
    recon = torch.zeros_like(planes)
    levels = torch.empty((b, nb, n, n), dtype=torch.int32, device=dev)
    modes = torch.empty((b, nb), dtype=torch.int32, device=dev)
    out = {"recon": recon, "levels": levels, "modes": modes}
    if b * nb == 0:
        return out
    kern = cuda_kernels()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    kern.ensure_tables(index)
    q = qp_scalars(qp, n, bit_depth, dequant_rescale)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kern.lib.nhv_wavefront_encode(
        planes.data_ptr(), b, hp, wp, n, BODIES[(mode_set, decision)],
        int(use_dst), *q, recon.data_ptr(), levels.data_ptr(),
        modes.data_ptr(), stream, index,
    )
    if rc != 0:
        raise RuntimeError(f"nhv_wavefront_encode failed: CUDA error {rc}")
    wavefront_encode_planes.launches += 1
    return out


wavefront_encode_planes.launches = 0
