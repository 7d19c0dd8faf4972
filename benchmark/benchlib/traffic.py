"""The frames a cell sends, made from the seed by one generator whose
parameters come from the cell's file: `frames` distinct 4:2:0 frames of
the configuration's size, 8-bit samples in int16 planes.

The content follows the port's smoke check (`chip_smoke.py::textured`
and `sequence_frames`, frozen here): each plane is a ramp plus a
sinusoidal wave, one 64x64 patch of every 2x2 group of patches set flat
to mid-grey, and uniform noise of amplitude `noise`; frame i rolls plane
k by (5i(k+1), 11i).  Unlike the smoke check, every frame draws its own
flat patches and noise, and the flat patches are spread evenly, one a
group, where the smoke check drew their number and places freely: a
seed's frames are so many independent draws, and every seed gives the
encoder about the same amount of work.
"""

from __future__ import annotations

import numpy as np


def pattern(h: int, w: int, bit_depth: int = 8) -> np.ndarray:
    """(h, w) int16: the ramp and wave that every plane of that size
    starts from."""
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = yy * (peak + 1) // max(h, 1) + xx * (peak + 1) // (2 * max(w, 1))
    wave = (peak // 8) * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    return (ramp + wave).astype(np.int16)


def textured(base: np.ndarray, noise: int, rng, bit_depth: int = 8) -> np.ndarray:
    """(h, w) int16 plane: `base` with one 64x64 patch of every 2x2
    group of patches flat, drawn from `rng`, and uniform noise of
    amplitude `noise`."""
    peak = (1 << bit_depth) - 1
    h, w = base.shape
    ty, tx = -(-h // 64), -(-w // 64)
    gy, gx = np.arange(0, ty, 2), np.arange(0, tx, 2)
    # A group at the plane's edge draws among the patches it holds.
    dy = (rng.random((gy.size, gx.size)) * np.minimum(2, ty - gy)[:, None])
    dx = (rng.random((gy.size, gx.size)) * np.minimum(2, tx - gx)[None, :])
    flat = np.zeros((ty, tx), bool)
    flat[gy[:, None] + dy.astype(int), gx[None, :] + dx.astype(int)] = True
    flat = np.repeat(np.repeat(flat, 64, 0), 64, 1)[:h, :w]
    plane = np.where(flat, np.int16(peak // 2), base)
    plane += rng.integers(-noise, noise + 1, (h, w), dtype=np.int16)
    return np.clip(plane, 0, peak, out=plane)


def make_frames(seed: int, count: int, height: int, width: int,
                noise: int, bit_depth: int = 8) -> list:
    """`count` distinct frames as (y, u, v) int16 arrays, from `seed`."""
    rng = np.random.default_rng(seed)
    sizes = ((height, width), (height // 2, width // 2),
             (height // 2, width // 2))
    bases = {s: pattern(*s, bit_depth) for s in set(sizes)}
    return [tuple(np.ascontiguousarray(np.roll(
                textured(bases[s], noise, rng, bit_depth),
                (5 * i * (k + 1), 11 * i), axis=(0, 1)))
                for k, s in enumerate(sizes))
            for i in range(count)]
