# Copy of nanohevc_tpu/runtime/__init__.py (only the import lines differ).
"""Native host runtime: entropy coding, NAL framing, bitstream assembly."""

from nanohevc_tpu_torch.runtime.entropy import (
    NAL_PPS,
    NAL_SLICE,
    NAL_SPS,
    NAL_VPS,
    decode_levels,
    encode_levels,
    wrap_nal,
    write_params,
)
from nanohevc_tpu_torch.runtime.bitstream import (
    assemble_bitstream,
    parse_bitstream,
)

__all__ = [
    "encode_levels",
    "decode_levels",
    "wrap_nal",
    "write_params",
    "assemble_bitstream",
    "parse_bitstream",
    "NAL_VPS",
    "NAL_SPS",
    "NAL_PPS",
    "NAL_SLICE",
]
