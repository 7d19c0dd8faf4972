"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each wrapper keeps its plain PyTorch version in the same module and a
launch count.  The CUDA library is built by `kernels.build` at the
first launch, never at import.
"""

from nanohevc_tpu_torch.kernels.slab_pipeline import (
    slab_encode_plane,
    slab_encode_plane_reference,
    slab_supported,
)

__all__ = [
    "slab_encode_plane",
    "slab_encode_plane_reference",
    "slab_supported",
]
