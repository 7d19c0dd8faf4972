"""Per-block costs and frame quality metrics, port of
`nanohevc_tpu/ops/metrics.py`.

Per-block variants reduce the last two axes of a (..., N, N) tensor
and return int32, as JAX does (PyTorch sums int32 into int64, so the
result is cast back; the sums are exact for 8/10-bit video:
32*32*1023^2 < 2^31).  mse/psnr/ssim reduce in float32 like the JAX
ops.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from nanohevc_tpu_torch.ref.metrics import hadamard_matrix


def mse(original: torch.Tensor, reconstructed: torch.Tensor) -> torch.Tensor:
    d = original.to(torch.float32) - reconstructed.to(torch.float32)
    return (d * d).mean()


def psnr(original: torch.Tensor, reconstructed: torch.Tensor,
         peak: int = 255) -> torch.Tensor:
    err = mse(original, reconstructed)
    return torch.where(
        err == 0, torch.tensor(float("inf"), device=err.device),
        10.0 * torch.log10((peak * peak) / err),
    )


def _box_mean(a: torch.Tensor, window: int) -> torch.Tensor:
    """Mean over each window x window box of a 2-D float32 tensor
    ("VALID": one value per box that fits), its terms added one shifted
    view at a time in raster order of the window, as XLA's CPU
    reduce_window adds them."""
    oh, ow = a.shape[0] - window + 1, a.shape[1] - window + 1
    acc = a[:oh, :ow]
    for i in range(window):
        for j in range(window):
            if i or j:
                acc = acc + a[i:i + oh, j:j + ow]
    return acc / (window * window)


def _ssim_map(x: torch.Tensor, y: torch.Tensor, peak: int,
              window: int) -> torch.Tensor:
    """SSIM of each window x window box of two float32 planes, in the
    JAX op's elementwise order, one op at a time."""
    mx, my = _box_mean(x, window), _box_mean(y, window)
    mxx, myy, mxy = (_box_mean(x * x, window), _box_mean(y * y, window),
                     _box_mean(x * y, window))
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    c1 = torch.tensor((0.01 * peak) ** 2, dtype=torch.float32, device=x.device)
    c2 = torch.tensor((0.03 * peak) ** 2, dtype=torch.float32, device=x.device)
    return ((2 * mx * my + c1) * (2 * cxy + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2)
    )


def ssim(original: torch.Tensor, reconstructed: torch.Tensor, peak: int = 255,
         window: int = 8) -> torch.Tensor:
    """Uniform-window SSIM of two 2-D planes, a float32 scalar.

    The per-box map (`_ssim_map`) equals the JAX op's bit for bit: the
    box sums hold integer-valued terms (at 8 bits every sum is below
    2^24, so exact in any order; above that they take reduce_window's
    order), and the elementwise expression keeps JAX's order.  The
    final mean over the map is PyTorch's, whose order XLA's CPU
    reduction does not share: it agrees with JAX's to about 1e-7.
    """
    return _ssim_map(original.to(torch.float32),
                     reconstructed.to(torch.float32), peak, window).mean()


def sad_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of absolute differences per block over the last two axes
    (broadcasts, e.g. (nb, 1, N, N) vs (nb, M, N, N) -> (nb, M))."""
    d = a.to(torch.int32) - b.to(torch.int32)
    return d.abs().sum(dim=(-2, -1)).to(torch.int32)


def satd_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hadamard-transformed SAD per block (Sylvester basis), as int32,
    with the same broadcasting as `sad_blocks`.

    The two passes run as float64 matmuls, exact for these integers.
    """
    n = a.shape[-1]
    h = torch.as_tensor(hadamard_matrix(n), dtype=torch.float64,
                        device=a.device)
    d = (a.to(torch.int32) - b.to(torch.int32)).to(torch.float64)
    t = torch.matmul(torch.matmul(h, d), h.T)
    return t.abs().sum(dim=(-2, -1)).to(torch.int32)


def residual_energy_blocks(residual: torch.Tensor) -> torch.Tensor:
    """Sum of squared residuals per block over the last two axes, int32."""
    r = residual.to(torch.int32)
    return (r * r).sum(dim=(-2, -1)).to(torch.int32)


# |level| + 1 covered by the log2 table of estimate_bits_blocks; the
# int32 quantizer keeps levels below 2^15.
_LOG2_TABLE_SIZE = 1 << 16


@lru_cache(maxsize=None)
def _log2_table(device: torch.device) -> torch.Tensor:
    """float32 log2(k) of k = 1.._LOG2_TABLE_SIZE at index k - 1, taken
    in float64 on the host and rounded once, so that CPU and card read
    the same bits."""
    k = np.arange(1, _LOG2_TABLE_SIZE + 1, dtype=np.float64)
    return torch.from_numpy(np.log2(k).astype(np.float32)).to(device)


def estimate_bits_blocks(levels: torch.Tensor) -> torch.Tensor:
    """Per-block rate estimate: sum(log2(|l|+1)) + 2 per nonzero, over
    all axes but the first, float32 (the reference's estimate_bits).

    log2 comes from a host table (`_log2_table`), which can differ from
    XLA's float32 log2 in the last place; the sum takes XLA's order
    (`ops.rate.ordered_sum`) over the flattened block.
    """
    from nanohevc_tpu_torch.ops.rate import ordered_sum

    a = levels.to(torch.int64).abs().reshape(levels.shape[0], -1)
    table = _log2_table(levels.device)
    idx = a.clamp(max=_LOG2_TABLE_SIZE - 1)
    bits = table[idx] + torch.where(a > 0, 2.0, 0.0)
    return ordered_sum(bits)


def count_nonzero_blocks(levels: torch.Tensor) -> torch.Tensor:
    """Per-block non-zero level count, int32."""
    return (levels != 0).reshape(levels.shape[0], -1).sum(dim=1).to(torch.int32)
