"""Frozen copies of the port's plain block ops (`nanohevc_tpu_torch/ops`),
only those the reference's closed loop needs."""

from plainref.ops.intra import (
    ALL_ANGULAR,
    angular_predict_modes,
    dc_predict,
    mode_filter_flags,
    planar_predict,
    smooth_refs,
)
from plainref.ops.transform import forward_transform, inverse_transform
from plainref.ops.quant import dequantize, quantize
from plainref.ops.scan import mode_scan_idx, scan_pack, scan_unpack
from plainref.ops.rdoq import rdoq_gain, rdoq_levels
from plainref.ops.deblock import deblock_plane
