"""Multi-frame batch encoders, mesh-less and sharded over a device mesh,
port of `nanohevc_tpu/parallel/sharding.py`.

`make_batch_encoder` (open loop) and `make_closed_loop_encoder` return
fn(planes (F, H, W) int32 tensor, qp int) -> dict of batched outputs
with per-frame PSNR (`ops.metrics.psnr`) and their mean.  Without a
mesh they run on the planes' device; with one (`parallel.mesh`, which
describes the execution model) the shards run on the mesh's devices
and the outputs are gathered onto its first device.  `donate` (XLA
buffer donation) is a JAX compile knob and is not taken.

Routing of the open loop follows the JAX package, with one rule for
each plane: the slab kernel (`encode_plane_fast`) where
`supports_fast_path` holds, the mode-search kernel
(`encode_plane_fast_modes`) where `supports_mode_search_fast_path`
holds, `encode_plane_full` otherwise.  RD cbf and RDOQ always take
`encode_plane_full`, plane by plane: the adaptive rate model prices
each plane from its own statistics, as JAX's per-frame vmap does.
Under a mesh, the kernels run on (frame, space) row shards
(`parallel.spatial`) where `sharded_fast_supported` names a variant;
every other batch runs the same per-plane rule on frame shards, each on
the first device of its mesh row.  JAX leaves its kernels on those
frame shards only because XLA's partitioner cannot split a Pallas call;
the port keeps them wherever they cover the width.  A batch that does
not divide over the "frame" axis, or (open loop) a height that does not
divide over the "space" axis, raises ValueError, where JAX's sharding
refuses it too.

QP: the JAX package's kernels bake config.qp at compile time, and its
XLA pipeline takes the qp argument.  The port's kernels take the QP at
each launch and give the plain pipeline's outputs bit for bit, so each
route passes them the QP JAX's route would use: config.qp on the
mesh-less kernel route and on the row shards, unless
`honor_runtime_qp` (rate control) is set, where JAX leaves its kernels
for XLA; the qp argument on the frame shards under a mesh, which JAX
always runs through XLA.

The closed loop runs `encode_planes_closed_loop` over the whole batch
(one launch of the wavefront kernel per call, the in-loop filters after
it), or under a mesh over each frame shard on the first device of its
mesh row (one launch per shard).  Rows are not split: the wavefront's
diagonal recurrence runs across the whole plane.  Its mean_psnr under a
mesh is the mean of the shards' means, as JAX's `pmean` over "frame".
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
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
from nanohevc_tpu_torch.parallel.mesh import Mesh, frame_sharded, move
from nanohevc_tpu_torch.parallel.spatial import (
    make_sharded_fast_encoder,
    sharded_fast_supported,
)


def _with_psnr(planes: torch.Tensor, out: dict) -> dict:
    frame_psnr = torch.stack([psnr(p, r) for p, r in zip(planes, out["recon"])])
    out["psnr"] = frame_psnr
    out["mean_psnr"] = frame_psnr.mean()
    return out


def _encode_planes(planes: torch.Tensor, qp: int, *, config: EncoderConfig,
                   is_luma: bool = True,
                   honor_runtime_qp: bool = True) -> dict:
    """(F, H, W) int32 planes -> dict of batched outputs, without PSNR.

    Each plane goes through the slab or the mode-search kernel where
    the configuration allows (see the module docstring), else the plain
    pipeline.  The kernels take config.qp unless honor_runtime_qp is
    set.
    """
    n = config.block_size if is_luma else config.chroma_block_size()
    width = planes.shape[-1]
    # rdo_cbf / rdoq run RD stages only the plain path has
    plain_only = config.rdo_cbf or config.rdoq
    if not plain_only and supports_fast_path(config, n, width, is_luma):
        fast = encode_plane_fast
    elif not plain_only and supports_mode_search_fast_path(config, n, width,
                                                           is_luma):
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
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _batch_step(planes: torch.Tensor, qp: int, **kw) -> dict:
    """`_encode_planes` with per-frame PSNR and their mean."""
    return _with_psnr(planes, _encode_planes(planes, qp, **kw))


def _on_row(step: Callable) -> Callable:
    """step(planes, qp) as a `frame_sharded` step: run on the first
    device of the shard's mesh row."""
    def run(planes: torch.Tensor, qp: int, row) -> dict:
        return step(move(planes, row[0]), qp)

    return run


def make_batch_encoder(config: EncoderConfig, mesh: Mesh | None = None,
                       is_luma: bool = True,
                       honor_runtime_qp: bool = False) -> Callable:
    """An open-loop multi-frame plane encoder.

    Returns fn(planes (F, H, W) int32, qp int) -> dict(recon, levels
    (F, nb, N*N) scan-packed, modes, nnz, psnr (F,), mean_psnr).  The
    kernels take config.qp unless honor_runtime_qp is set; the plain
    pipeline always takes the qp argument.  With a mesh, see the module
    docstring for the routing.
    """
    if mesh is None:
        return partial(_batch_step, config=config, is_luma=is_luma,
                       honor_runtime_qp=honor_runtime_qp)
    first = mesh.devices.flat[0]
    # JAX's frame-sharded route is its XLA pipeline, which takes the qp
    # argument
    per_plane = frame_sharded(_on_row(partial(
        _encode_planes, config=config, is_luma=is_luma,
        honor_runtime_qp=True)), mesh)

    def dispatch(planes: torch.Tensor, qp: int) -> dict:
        h, w = planes.shape[-2:]
        space = mesh.shape["space"]
        if h % space:
            raise ValueError(f"plane height {h} does not divide over the "
                             f"mesh 'space' axis ({space})")
        variant = (None if config.rdo_cbf or config.rdoq
                   else sharded_fast_supported(config, mesh, h, w, is_luma))
        if variant is None:
            out = per_plane(planes, qp)
        else:
            fast = make_sharded_fast_encoder(config, mesh, variant, is_luma)
            out = fast(planes, qp if honor_runtime_qp else config.qp)
            out["nnz"] = (out["levels"] != 0).sum(-1).to(torch.int32)
        return _with_psnr(move(planes, first).to(torch.int32), out)

    return dispatch


def make_closed_loop_encoder(config: EncoderConfig, mesh: Mesh | None = None,
                             is_luma: bool = True) -> Callable:
    """A multi-frame closed-loop (wavefront) encoder.

    Returns fn(planes (F, H, W) int32, qp int) -> dict(recon, levels
    (F, nb, N*N) scan-packed, modes (F, nb), psnr (F,), mean_psnr,
    and the per-frame "sao" or "sao_ctb" parameters where the config
    asks for them).  The frames' same-index diagonals are coded together
    (under decision="rd" each frame is decided on its own slot batches,
    as in JAX); the filters act on each frame.  With a mesh the batch
    splits over its "frame" axis (see the module docstring).
    """
    args = plane_args(config, is_luma)

    def step(planes: torch.Tensor, qp: int) -> dict:
        return encode_planes_closed_loop(planes.to(torch.int32), int(qp),
                                         **args)

    if mesh is None:
        def run(planes: torch.Tensor, qp: int) -> dict:
            src = planes.to(torch.int32)
            return _with_psnr(src, step(src, qp))

        return run
    first = mesh.devices.flat[0]
    sharded = frame_sharded(_on_row(step), mesh)

    def run_sharded(planes: torch.Tensor, qp: int) -> dict:
        out = _with_psnr(move(planes, first).to(torch.int32),
                         sharded(planes, qp))
        # the mean of the frame shards' means, as JAX's pmean
        out["mean_psnr"] = out["psnr"].reshape(mesh.shape["frame"], -1
                                               ).mean(1).mean()
        return out

    return run_sharded


def encode_batch_sharded(planes, qp: int, config: EncoderConfig,
                         mesh: Mesh) -> dict:
    """Convenience wrapper: the planes (array-like, (F, H, W)) as an
    int32 tensor, then `make_batch_encoder(config, mesh)`."""
    if not isinstance(planes, torch.Tensor):
        planes = torch.from_numpy(np.ascontiguousarray(planes, np.int32))
    return make_batch_encoder(config, mesh)(planes.to(torch.int32), int(qp))
