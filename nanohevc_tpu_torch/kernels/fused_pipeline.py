"""The blocks-API fused all-intra pipeline: CUDA kernel wrapper and its
plain PyTorch version.

Port of the TPU kernel `nanohevc_tpu/kernels/fused_pipeline.py`
(`fused_encode_blocks` and `fused_encode_planes`, the public blocks API
that `nanohevc_tpu.kernels` exports).  The kernel is
`csrc/fused_pipeline.cu`, its body K1's `csrc/row_tail.cuh`; their
headers say how it is laid out and what bounds it.  It reads and writes
16-byte rows, so blocks whose data pointer is not 16-byte aligned are
copied first, counted in `fused_encode_blocks.copies`.  Per block: DC and planar from the given references, the
pick by residual energy (ties to DC), DCT, deadzone quantizer, parity
dequantizer, inverse DCT, clip.  What sets it apart from the open-loop
slab kernel (`kernels.slab_pipeline`), as in the JAX package:

- the DCT at every N, 4x4 included (no DST);
- the parity dequantizer only (no `dequant_rescale`);
- QP clamped to [0, 51];
- `fused_encode_planes` extracts the references with the default fill
  of 128 whatever the bit depth (so 128, not 512, at 10 bits), and its
  recon is zero right of and below the last full block (K1 passes those
  samples through);
- the frames of `fused_encode_planes` fold into the block axis: one
  launch for the whole batch.

`chunk` and `interpret` of the JAX functions are TPU layout and run
knobs (the lane-axis chunk of blocks, the Pallas interpreter) and are
not taken.

`fused_encode_blocks` dispatches on the device of its input: a CPU
tensor goes to `fused_encode_blocks_reference`, a CUDA tensor to the
kernel (or an exception).  There is no fallback from one to the other.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels.slab_pipeline import BLOCK_SIZES, aligned16
from nanohevc_tpu_torch.params import qp_scalars


def _validate(blocks: torch.Tensor, refs: torch.Tensor, bit_depth: int) -> int:
    """Raise on inputs the kernel does not take; returns N."""
    what = "fused_encode_blocks"
    if not isinstance(blocks, torch.Tensor) or blocks.dim() != 3 \
            or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"{what} needs (nb, N, N) blocks")
    n = blocks.shape[1]
    if n not in BLOCK_SIZES:
        raise ValueError(f"unsupported block size: {n}")
    if not isinstance(refs, torch.Tensor) or tuple(refs.shape) != (
            blocks.shape[0], 4 * n + 2):
        raise ValueError(f"{what} needs (nb, 4N+2) = ({blocks.shape[0]}, "
                         f"{4 * n + 2}) refs")
    for t in (blocks, refs):
        if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
            raise TypeError(f"{what} needs integer tensors, got {t.dtype}")
    if blocks.device != refs.device:
        raise ValueError(f"{what}: blocks on {blocks.device}, refs on "
                         f"{refs.device}")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {blocks.device}")
    if not 1 <= bit_depth <= 16:
        raise ValueError(f"unsupported bit depth: {bit_depth}")
    return n


def fused_encode_blocks_reference(blocks: torch.Tensor, refs: torch.Tensor,
                                  qp: int, *, bit_depth: int = 8) -> tuple:
    """Plain PyTorch version of the kernel, on the inputs' device.

    (nb, N, N) blocks and (nb, 4N+2) refs -> (recon (nb, N, N), levels
    (nb, N, N) raster), both int32.
    """
    n = blocks.shape[-1]
    blocks = blocks.to(torch.int32)
    refs = refs.to(torch.int32)
    dc = ops.dc_predict(refs, n)
    pl = ops.planar_predict(refs, n)
    dc_wins = (ops.residual_energy_blocks(blocks - dc)
               <= ops.residual_energy_blocks(blocks - pl))
    pred = torch.where(dc_wins[:, None, None], dc, pl)
    levels = ops.quantize(ops.forward_transform(blocks - pred, False), qp, n)
    rec_res = ops.inverse_transform(ops.dequantize(levels, qp, n), False)
    recon = (pred + rec_res).clamp(0, (1 << bit_depth) - 1)
    return recon.to(torch.int32), levels.to(torch.int32)


@lru_cache(maxsize=None)
def cuda_kernels():
    """Build (at first use) and load this kernel's CUDA library."""
    from nanohevc_tpu_torch.kernels.build import KernelLibrary

    return KernelLibrary("fused_pipeline")


def fused_encode_blocks(blocks: torch.Tensor, refs: torch.Tensor, qp: int, *,
                        bit_depth: int = 8) -> tuple:
    """(nb, N, N) blocks + (nb, 4N+2) refs -> (recon, levels), both
    (nb, N, N) int32 raster, as `fused_encode_blocks_reference` says.

    qp is a Python int, clamped to [0, 51].  On CUDA tensors this
    launches the hand-written kernel once on the current stream (no
    synchronisation) and adds one to `fused_encode_blocks.launches` (and
    to `.copies` when the blocks had to be copied to 16-byte alignment);
    on CPU tensors it runs the plain version.
    """
    n = _validate(blocks, refs, bit_depth)
    if blocks.device.type == "cpu":
        return fused_encode_blocks_reference(blocks, refs, qp,
                                             bit_depth=bit_depth)
    blocks = aligned16(blocks.to(torch.int32).contiguous(), fused_encode_blocks)
    refs = refs.to(torch.int32).contiguous()
    nb = blocks.shape[0]
    dev = blocks.device
    recon = torch.empty_like(blocks)
    levels = torch.empty_like(blocks)
    if nb == 0:
        return recon, levels
    kern = cuda_kernels()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    q = qp_scalars(qp, n, bit_depth, dequant_rescale=False)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = kern.lib.nhv_fused_encode(
        blocks.data_ptr(), refs.data_ptr(), nb, n, *q, recon.data_ptr(),
        levels.data_ptr(), stream, index,
    )
    if rc != 0:
        raise RuntimeError(f"nhv_fused_encode failed: CUDA error {rc}")
    fused_encode_blocks.launches += 1
    return recon, levels


fused_encode_blocks.launches = 0
fused_encode_blocks.copies = 0


def _encode_planes(planes: torch.Tensor, qp: int, n: int, bit_depth: int,
                   encode_blocks) -> dict:
    if not isinstance(planes, torch.Tensor) or planes.dim() != 3:
        raise ValueError("fused_encode_planes needs (F, H, W) planes")
    f, h, w = planes.shape
    src = planes.to(torch.int32)
    blocks = torch.stack([ops.tile_plane(p, n) for p in src])
    # The default fill of 128 at every bit depth, as the JAX package.
    refs = torch.stack([ops.extract_refs(p, n) for p in src])
    nb = blocks.shape[1]
    recon_b, levels = encode_blocks(
        blocks.reshape(f * nb, n, n), refs.reshape(f * nb, 4 * n + 2), qp,
        bit_depth=bit_depth)
    recon = torch.stack([ops.untile_plane(b, h, w)
                         for b in recon_b.reshape(f, nb, n, n)])
    return {"recon": recon, "levels": levels.reshape(f, nb, n * n)}


def fused_encode_planes_reference(planes: torch.Tensor, qp: int, n: int, *,
                                  bit_depth: int = 8) -> dict:
    """Plain PyTorch version of `fused_encode_planes`."""
    return _encode_planes(planes, qp, n, bit_depth,
                          fused_encode_blocks_reference)


def fused_encode_planes(planes: torch.Tensor, qp: int, n: int, *,
                        bit_depth: int = 8) -> dict:
    """(F, H, W) planes -> dict(recon (F, H, W), levels (F, nb, N*N)
    raster, both int32).

    Tiles each plane into its full N x N blocks, extracts their
    references (fill 128), runs `fused_encode_blocks` once over the F*nb
    blocks, and untiles the recon with zeros where no full block lies.
    On CUDA planes the kernel launches once; on CPU planes the plain
    version runs.
    """
    return _encode_planes(planes, qp, n, bit_depth, fused_encode_blocks)
