"""nanohevc_tpu_torch: the PyTorch/CUDA port of nanohevc_tpu.

The JAX package `nanohevc_tpu` stays the reference.  This package
imports `torch` and numpy, never `jax` and nothing of `nanohevc_tpu`:
it keeps its own copies of the host modules it needs (`tables`,
`config`, `frame`, `ref`, `runtime` and `ops/rate_tables.py`, each
headed by the file it copies).

Layout mirrors the JAX package so each counterpart is easy to find:

- `params`: spec tables and per-QP scalars as int32 tensors;
- `ops`: plain PyTorch formulations of the block ops (CPU and CUDA),
  the rate models (`ops.rate`, `ops.mode_rate`) and RDOQ (`ops.rdoq`);
- `kernels`: hand-written CUDA kernels and their wrappers, the blocks
  API `fused_encode_blocks` / `fused_encode_planes` among them;
- `models.all_intra`: the open-loop all-intra frame encoder;
- `models.wavefront`: the closed-loop (wavefront) encoder and decoder;
- `models.rate_control`: the per-frame QP search and the sequence's
  rate controller;
- `models.sequence`: the multi-frame sequence encoder (resume, rate
  control) and its decoder;
- `parallel`: the device mesh (`make_mesh`) and the multi-frame batch
  encoders, frame- and space-sharded over it (`parallel.spatial`);
- `ops.sparse`: the level-prefix device-to-host transfer;
- `utils.tracing`: the frame call's stages and byte counters.  Run
  the frame API under `torch.profiler` to see the `nhevc.*` stages
  (the planes' upload, fetch and conversions, the entropy coder's SAO,
  mode, scan and residual parts) beside the kernels and copies on the
  card; read `tracing.SPANS.report()` and `tracing.COUNTS` for their
  totals.  With no profiler recording, each stage costs one flag read.
  Also the sequence runner's stopwatch;
  `utils.checks`: sampled oracle parity of an open-loop encode;
- `cli`: `python -m nanohevc_tpu_torch [--device cuda|cpu]
  demo|encode|encode-seq|decode`.

The reference API that the JAX package re-exports (`Plane`, `Frame`,
`BlockView`, the single-block intra, transform, quant and metrics
functions of the numpy oracle `ref`) is re-exported here from the
port's own copies.

Entry points run on the CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(name: str | torch.device) -> torch.device:
    """Map a device name to a torch.device, refusing a missing card.

    Asking for "cuda" when `torch.cuda.is_available()` is False raises
    RuntimeError; the CPU is never substituted.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but torch.cuda.is_available() "
            "is False (no CUDA card or a CPU-only PyTorch build)"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type: {dev.type}")
    return dev


from nanohevc_tpu_torch.frame import Plane, Frame, PackedFrame, FrameBufferPool  # noqa: E402
from nanohevc_tpu_torch.block import BlockView, iterate_blocks  # noqa: E402
from nanohevc_tpu_torch.ref.intra import (  # noqa: E402
    INTRA_PRED_ANGLE,
    intra_dc_predict_4x4,
    intra_dc_predict,
    intra_planar_predict,
    intra_angular_predict,
    residual_block,
    reconstruct_block,
    clip_to_pixel_range,
)
from nanohevc_tpu_torch.ref.transform import (  # noqa: E402
    forward_transform,
    inverse_transform,
    forward_transform_4x4,
    inverse_transform_4x4,
    forward_transform_8x8,
    inverse_transform_8x8,
    forward_transform_16x16,
    inverse_transform_16x16,
    forward_transform_32x32,
    inverse_transform_32x32,
    DCT4,
    DCT8,
    DCT16,
    DCT32,
    DST4,
)
from nanohevc_tpu_torch.ref.quant import (  # noqa: E402
    quantize,
    dequantize,
    quantize_block,
    dequantize_block,
    QUANT_SCALE,
    DEQUANT_SCALE,
)
from nanohevc_tpu_torch.ref.metrics import (  # noqa: E402
    psnr,
    mse,
    sad,
    satd_4x4,
    residual_energy,
)
from nanohevc_tpu_torch.models.all_intra import (  # noqa: E402
    create_test_frame,
    encode_frame_full,
    encode_frame_intra,
)
from nanohevc_tpu_torch.kernels.fused_pipeline import (  # noqa: E402
    fused_encode_blocks,
    fused_encode_planes,
)
from nanohevc_tpu_torch.models.sequence import (  # noqa: E402
    decode_sequence,
    encode_sequence,
)
from nanohevc_tpu_torch.models.wavefront import (  # noqa: E402
    decode_frame,
    decode_plane,
    decode_planes,
    encode_frame_closed_loop,
    encode_plane_closed_loop,
    encode_planes_closed_loop,
)

__all__ = [
    "resolve_device",
    "encode_frame_full",
    "encode_frame_intra",
    "create_test_frame",
    "encode_planes_closed_loop",
    "encode_plane_closed_loop",
    "encode_frame_closed_loop",
    "decode_planes",
    "decode_plane",
    "decode_frame",
    "encode_sequence",
    "decode_sequence",
    "fused_encode_planes",
    "fused_encode_blocks",
    # the reference API, as the JAX package exports it
    "Plane",
    "Frame",
    "PackedFrame",
    "FrameBufferPool",
    "BlockView",
    "iterate_blocks",
    "INTRA_PRED_ANGLE",
    "intra_dc_predict_4x4",
    "intra_dc_predict",
    "intra_planar_predict",
    "intra_angular_predict",
    "residual_block",
    "reconstruct_block",
    "clip_to_pixel_range",
    "forward_transform",
    "inverse_transform",
    "forward_transform_4x4",
    "inverse_transform_4x4",
    "forward_transform_8x8",
    "inverse_transform_8x8",
    "forward_transform_16x16",
    "inverse_transform_16x16",
    "forward_transform_32x32",
    "inverse_transform_32x32",
    "DCT4",
    "DCT8",
    "DCT16",
    "DCT32",
    "DST4",
    "quantize",
    "dequantize",
    "quantize_block",
    "dequantize_block",
    "QUANT_SCALE",
    "DEQUANT_SCALE",
    "psnr",
    "mse",
    "sad",
    "satd_4x4",
    "residual_energy",
]
