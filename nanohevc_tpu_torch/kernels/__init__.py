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
from nanohevc_tpu_torch.kernels.fused_pipeline import (
    fused_encode_blocks,
    fused_encode_blocks_reference,
    fused_encode_planes,
    fused_encode_planes_reference,
)
from nanohevc_tpu_torch.kernels.decode import (
    decode_blocks,
    decode_blocks_reference,
)
from nanohevc_tpu_torch.kernels.loop_filter import (
    deblock_planes,
    sao_apply,
    sao_decide_reference,
    sao_estimate,
    sao_statistics_reference,
)
from nanohevc_tpu_torch.kernels.wavefront import (
    wavefront_encode_planes,
    wavefront_encode_planes_reference,
    wavefront_supported,
)
from nanohevc_tpu_torch.kernels.wavefront_rd import (
    wavefront_rd_encode_planes,
    wavefront_rd_encode_planes_reference,
)

__all__ = [
    "deblock_planes",
    "decode_blocks",
    "decode_blocks_reference",
    "fused_encode_blocks",
    "fused_encode_blocks_reference",
    "fused_encode_planes",
    "fused_encode_planes_reference",
    "mode_search_encode_plane",
    "mode_search_encode_plane_reference",
    "mode_search_supported",
    "sao_apply",
    "sao_decide_reference",
    "sao_estimate",
    "sao_statistics_reference",
    "slab_encode_plane",
    "slab_encode_plane_reference",
    "slab_supported",
    "wavefront_encode_planes",
    "wavefront_encode_planes_reference",
    "wavefront_rd_encode_planes",
    "wavefront_rd_encode_planes_reference",
    "wavefront_supported",
]
