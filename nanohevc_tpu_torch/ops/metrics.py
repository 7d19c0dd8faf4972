"""Per-block costs and frame quality metrics, port of
`nanohevc_tpu/ops/metrics.py`.

Per-block variants reduce the last two axes of a (..., N, N) tensor
and return int32, as JAX does (PyTorch sums int32 into int64, so the
result is cast back; the sums are exact for 8/10-bit video:
32*32*1023^2 < 2^31).  mse/psnr reduce in float32 like the JAX ops.
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
