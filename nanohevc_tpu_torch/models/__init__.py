"""Full-frame encoder pipelines."""

from nanohevc_tpu_torch.models.all_intra import (
    encode_plane_parity,
    encode_plane_full,
    encode_frame_intra,
    encode_frame_full,
    create_test_frame,
)

__all__ = [
    "encode_plane_parity",
    "encode_plane_full",
    "encode_frame_intra",
    "encode_frame_full",
    "create_test_frame",
]
