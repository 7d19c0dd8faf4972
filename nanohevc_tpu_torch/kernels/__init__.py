"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Each wrapper keeps its plain PyTorch version in the same module and a
launch count.  The CUDA libraries are built by `kernels.build` at the
first launch, never at import.
"""

from nanohevc_tpu_torch.kernels.slab_pipeline import (
    slab_encode_plane,
    slab_encode_plane_reference,
    slab_supported,
)
from nanohevc_tpu_torch.kernels.mode_search import (
    mode_search_encode_plane,
    mode_search_encode_plane_reference,
    mode_search_supported,
)
from nanohevc_tpu_torch.kernels.wavefront import (
    wavefront_encode_planes,
    wavefront_encode_planes_reference,
    wavefront_supported,
)

__all__ = [
    "mode_search_encode_plane",
    "mode_search_encode_plane_reference",
    "mode_search_supported",
    "slab_encode_plane",
    "slab_encode_plane_reference",
    "slab_supported",
    "wavefront_encode_planes",
    "wavefront_encode_planes_reference",
    "wavefront_supported",
]
