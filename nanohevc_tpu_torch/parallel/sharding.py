"""Multi-frame batch encoders, port of the mesh-less part of
`nanohevc_tpu/parallel/sharding.py`.

`make_batch_encoder` (open loop) and `make_closed_loop_encoder` return
fn(planes (F, H, W) int32 tensor, qp int) -> dict of batched outputs
with per-frame PSNR (`ops.metrics.psnr`) and their mean, on the planes'
device.  A `mesh` (frames spread over several cards) raises
NotImplementedError: that part, with the JAX package's `mesh.py` and
`spatial.py`, is not ported yet.  `donate` (XLA buffer donation) is a
JAX compile knob and is not taken.

Routing of the open loop follows the JAX package plane by plane: the
slab kernel (`encode_plane_fast`) where `supports_fast_path` holds, the
mode-search kernel (`encode_plane_fast_modes`) where
`supports_mode_search_fast_path` holds, `encode_plane_full` otherwise.
The JAX package leaves its kernels under `honor_runtime_qp` (rate
control) only because a Pallas kernel bakes its QP at compile time;
the port's kernels take the QP at each launch and give the XLA path's
outputs bit for bit, so they stay on the path and receive the runtime
QP.  Without `honor_runtime_qp` the kernels take `config.qp`, as in
the JAX package.  RD cbf and RDOQ take the plain pipeline, plane by
plane: the adaptive rate model prices each plane from its own
statistics, as JAX's per-frame vmap does.  The closed loop runs
`encode_planes_closed_loop` over the whole batch: one launch of the
wavefront kernel per call, the in-loop filters after it.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.models.all_intra import (
    encode_plane_fast,
    encode_plane_fast_modes,
    encode_plane_full,
    supports_fast_path,
    supports_mode_search_fast_path,
)
from nanohevc_tpu_torch.models.wavefront import (
    encode_planes_closed_loop,
    plane_args,
)
from nanohevc_tpu_torch.ops.metrics import psnr


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharding a batch over a device mesh is not ported yet")


def _with_psnr(planes: torch.Tensor, out: dict) -> dict:
    frame_psnr = torch.stack([psnr(p, r) for p, r in zip(planes, out["recon"])])
    out["psnr"] = frame_psnr
    out["mean_psnr"] = frame_psnr.mean()
    return out


def _batch_step(planes: torch.Tensor, qp: int, *, config: EncoderConfig,
                is_luma: bool = True, allow_fast: bool = True,
                honor_runtime_qp: bool = True) -> dict:
    """(F, H, W) int32 planes -> dict of batched outputs + PSNR.

    Each plane goes through the slab or the mode-search kernel where
    the configuration allows (see the module docstring), else the plain
    pipeline; allow_fast=False forces the plain pipeline.  The kernels
    take config.qp unless honor_runtime_qp is set.
    """
    n = config.block_size if is_luma else config.chroma_block_size()
    width = planes.shape[-1]
    # rdo_cbf / rdoq run RD stages only the plain path has
    if config.rdo_cbf or config.rdoq:
        allow_fast = False
    if allow_fast and supports_fast_path(config, n, width, is_luma):
        fast = encode_plane_fast
    elif allow_fast and supports_mode_search_fast_path(config, n, width, is_luma):
        fast = encode_plane_fast_modes
    else:
        fast = None
    if fast is not None:
        kernel_qp = qp if honor_runtime_qp else config.qp

        def one(plane):
            return fast(
                plane, kernel_qp, n=n, bit_depth=config.bit_depth,
                scan=config.scan, use_dst=config.use_dst(n, is_luma),
                dequant_rescale=config.dequant_rescale,
            )
    else:
        def one(plane):
            return encode_plane_full(
                plane,
                qp,
                n=n,
                mode_set=(config.mode_set if is_luma
                          else config.chroma_modes()),
                decision=config.decision,
                use_dst=config.use_dst(n, is_luma),
                is_intra=config.is_intra,
                bit_depth=config.bit_depth,
                scan=config.scan,
                rdo_cbf=config.rdo_cbf,
                rdoq=config.rdoq,
                dequant_rescale=config.dequant_rescale,
                intra_smoothing=config.intra_smoothing and is_luma,
            )

    outs = [one(p) for p in planes]
    out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return _with_psnr(planes, out)


def make_batch_encoder(config: EncoderConfig, mesh=None, is_luma: bool = True,
                       honor_runtime_qp: bool = False) -> Callable:
    """An open-loop multi-frame plane encoder.

    Returns fn(planes (F, H, W) int32, qp int) -> dict(recon, levels
    (F, nb, N*N) scan-packed, modes, nnz, psnr (F,), mean_psnr).  The
    kernels take config.qp unless honor_runtime_qp is set; the plain
    pipeline always takes the qp argument.
    """
    _refuse_mesh(mesh)
    return partial(_batch_step, config=config, is_luma=is_luma,
                   honor_runtime_qp=honor_runtime_qp)


def make_closed_loop_encoder(config: EncoderConfig, mesh=None,
                             is_luma: bool = True) -> Callable:
    """A multi-frame closed-loop (wavefront) encoder.

    Returns fn(planes (F, H, W) int32, qp int) -> dict(recon, levels
    (F, nb, N*N) scan-packed, modes (F, nb), psnr (F,), mean_psnr,
    and the per-frame "sao" or "sao_ctb" parameters where the config
    asks for them).  The F frames' same-index diagonals are coded
    together (under decision="rd" each frame is decided on its own slot
    batches, as in JAX); the filters act on the whole batch.
    """
    _refuse_mesh(mesh)
    args = plane_args(config, is_luma)

    def run(planes: torch.Tensor, qp: int) -> dict:
        src = planes.to(torch.int32)
        return _with_psnr(src, encode_planes_closed_loop(src, int(qp), **args))

    return run
