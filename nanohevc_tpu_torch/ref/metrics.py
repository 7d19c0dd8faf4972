# Copy of nanohevc_tpu/ref/metrics.py (only the import lines and reference paths differ).
"""Quality metrics oracle (parity: reference/nano_hevc/metrics.py)."""

from __future__ import annotations

import numpy as np

__all__ = ["mse", "psnr", "ssim", "sad", "satd_4x4", "hadamard_matrix", "residual_energy"]


def mse(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """Mean squared error in float64."""
    d = original.astype(np.float64) - reconstructed.astype(np.float64)
    return float(np.mean(d * d))


def psnr(original: np.ndarray, reconstructed: np.ndarray, peak: int = 255) -> float:
    """Peak signal-to-noise ratio in dB; +inf for identical inputs."""
    err = mse(original, reconstructed)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / err))


def sad(a: np.ndarray, b: np.ndarray) -> int:
    """Sum of absolute differences."""
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester-ordered {-1, +1} Hadamard matrix, n a power of two.

    The n == 4 case matches the reference's hard-coded H
    (metrics.py:35-40) up to a row permutation, which leaves the SATD
    sum unchanged; satd_4x4 uses the exact reference row order.
    """
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


# Reference row order: sequency-style [++++, ++--, +--+, +-+-].
_H4 = np.array(
    [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], dtype=np.int32
)


def satd_4x4(a: np.ndarray, b: np.ndarray) -> int:
    """Sum of absolute transformed (4x4 Hadamard) differences."""
    d = (a.astype(np.int32) - b.astype(np.int32)).reshape(4, 4)
    return int(np.abs(_H4 @ d @ _H4.T).sum())


def residual_energy(residual: np.ndarray) -> int:
    """Sum of squared residuals (int64 accumulation)."""
    r = residual.astype(np.int64)
    return int((r * r).sum())


def ssim(original: np.ndarray, reconstructed: np.ndarray, peak: int = 255,
         window: int = 8) -> float:
    """Structural similarity with a uniform window (codec-style SSIM).

    Mean SSIM over all full window positions (stride 1), constants
    C1=(0.01 L)^2, C2=(0.03 L)^2.  The reference has no SSIM at all;
    this is a capability extension (BASELINE config 4).
    """
    x = original.astype(np.float64)
    y = reconstructed.astype(np.float64)

    def box(a):  # mean filter over window x window, valid positions
        c = np.cumsum(np.cumsum(a, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        w = window
        s = c[w:, w:] - c[:-w, w:] - c[w:, :-w] + c[:-w, :-w]
        return s / (w * w)

    mx, my = box(x), box(y)
    mxx, myy, mxy = box(x * x), box(y * y), box(x * y)
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2)
    )
    return float(s.mean())
