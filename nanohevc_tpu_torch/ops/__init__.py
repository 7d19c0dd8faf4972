"""Plain PyTorch block ops: the port of `nanohevc_tpu.ops` for the
open-loop slice (DC/planar and the 35-mode search), the closed loop,
the RD stages (rate models, RDOQ) and the in-loop filters (deblocking
here; SAO in `ops.sao` and `ops.sao_ctb`).

Everything operates on a `(num_blocks, N, N)` int32 block tensor on
whatever device the input lies on (CPU or CUDA), integer-exact and
held bit-exact against the JAX ops in tests/test_torch_ops.py.
"""

from nanohevc_tpu_torch.ops.tiling import (
    extract_refs,
    extract_refs_at,
    num_blocks,
    tile_plane,
    untile_plane,
)
from nanohevc_tpu_torch.ops.intra import (
    ALL_ANGULAR,
    angular_predict_all,
    angular_predict_modes,
    cat_refs,
    dc_predict,
    mode_filter_flags,
    planar_predict,
    predict_by_mode,
    predict_by_mode_mm,
    smooth_refs,
)
from nanohevc_tpu_torch.ops.transform import forward_transform, inverse_transform
from nanohevc_tpu_torch.ops.quant import dequantize, quantize
from nanohevc_tpu_torch.ops.scan import mode_scan_idx, scan_pack, scan_unpack
from nanohevc_tpu_torch.ops.metrics import (
    count_nonzero_blocks,
    estimate_bits_blocks,
    mse,
    psnr,
    residual_energy_blocks,
    sad_blocks,
    satd_blocks,
    ssim,
)
from nanohevc_tpu_torch.ops.rate import (
    RateTable,
    calibrate_rate_table,
    model_bits as rate_model_bits,
    model_bits_adaptive as rate_model_bits_adaptive,
)
from nanohevc_tpu_torch.ops.rdoq import rdoq_gain, rdoq_levels
from nanohevc_tpu_torch.ops.deblock import deblock_plane

__all__ = [
    "tile_plane",
    "untile_plane",
    "extract_refs",
    "extract_refs_at",
    "num_blocks",
    "dc_predict",
    "planar_predict",
    "ALL_ANGULAR",
    "angular_predict_all",
    "angular_predict_modes",
    "predict_by_mode",
    "predict_by_mode_mm",
    "mode_filter_flags",
    "smooth_refs",
    "cat_refs",
    "forward_transform",
    "inverse_transform",
    "quantize",
    "dequantize",
    "scan_pack",
    "scan_unpack",
    "mode_scan_idx",
    "mse",
    "psnr",
    "ssim",
    "sad_blocks",
    "satd_blocks",
    "residual_energy_blocks",
    "estimate_bits_blocks",
    "count_nonzero_blocks",
    "RateTable",
    "calibrate_rate_table",
    "rate_model_bits",
    "rate_model_bits_adaptive",
    "rdoq_levels",
    "rdoq_gain",
    "deblock_plane",
]
