"""Per-block costs and frame quality metrics, port of
`nanohevc_tpu/ops/metrics.py`.

Per-block variants reduce the last two axes of a (..., N, N) tensor
and return int32, as JAX does (PyTorch sums int32 into int64, so the
result is cast back; the sums are exact for 8/10-bit video:
32*32*1023^2 < 2^31).  mse/psnr reduce in float32 like the JAX ops.
"""

from __future__ import annotations

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
