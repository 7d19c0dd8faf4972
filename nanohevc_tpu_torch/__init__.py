"""nanohevc_tpu_torch: the PyTorch/CUDA port of nanohevc_tpu.

The JAX package `nanohevc_tpu` stays the reference.  This package
imports `torch` and numpy, never `jax` and nothing of `nanohevc_tpu`:
it keeps its own copies of the host modules it needs (`tables`,
`config`, `frame`, `ref` and `runtime`, each headed by the file it
copies).

Layout mirrors the JAX package so each counterpart is easy to find:

- `params`: spec tables and per-QP scalars as int32 tensors;
- `ops`: plain PyTorch formulations of the block ops (CPU and CUDA);
- `kernels`: hand-written CUDA kernels and their wrappers;
- `models.all_intra`: the open-loop all-intra frame encoder;
- `models.wavefront`: the closed-loop (wavefront) encoder and decoder;
- `cli`: `python -m nanohevc_tpu_torch [--device cuda|cpu]
  demo|encode|decode`.

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


from nanohevc_tpu_torch.models.all_intra import (  # noqa: E402
    create_test_frame,
    encode_frame_full,
    encode_frame_intra,
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
]
