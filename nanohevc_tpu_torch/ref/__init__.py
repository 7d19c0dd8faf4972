# Copy of nanohevc_tpu/ref/__init__.py (only the import lines and reference paths differ).
"""Clean-room vectorized numpy oracle for the HEVC front-half ops.

This package is the bit-exactness referee for the JAX/Pallas device
path and also backs the single-block public API (the "CPU numpy path"
of BASELINE.json config 1).  Behavior matches the reference
implementation (reference/nano_hevc) observable semantics, but
every function here is vectorized numpy — no per-pixel Python loops.
"""

from nanohevc_tpu_torch.ref.intra import (
    intra_dc_predict,
    intra_dc_predict_4x4,
    intra_planar_predict,
    intra_angular_predict,
    residual_block,
    reconstruct_block,
    clip_to_pixel_range,
)
from nanohevc_tpu_torch.ref.transform import forward_transform, inverse_transform
from nanohevc_tpu_torch.ref.quant import (
    get_qp_params,
    quantize,
    dequantize,
    quantize_block,
    dequantize_block,
    estimate_bits,
    count_nonzero,
    is_all_zero,
)
from nanohevc_tpu_torch.ref.metrics import mse, psnr, sad, satd_4x4, residual_energy

__all__ = [
    "intra_dc_predict",
    "intra_dc_predict_4x4",
    "intra_planar_predict",
    "intra_angular_predict",
    "residual_block",
    "reconstruct_block",
    "clip_to_pixel_range",
    "forward_transform",
    "inverse_transform",
    "get_qp_params",
    "quantize",
    "dequantize",
    "quantize_block",
    "dequantize_block",
    "estimate_bits",
    "count_nonzero",
    "is_all_zero",
    "mse",
    "psnr",
    "sad",
    "satd_4x4",
    "residual_energy",
]
