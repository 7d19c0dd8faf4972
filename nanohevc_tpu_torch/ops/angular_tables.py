"""Static per-(size, mode) index/weight tables for angular prediction.

Port of `nanohevc_tpu/ops/angular_tables.py` (numpy only: the JAX
module cannot be imported without JAX).  For a fixed block size every
mode's reference-array construction and per-pixel projection are
constants:

  src[m, p]   : which element of the combined per-block reference
                vector (`ops.tiling.extract_refs`, length 4N+2) lands
                at position p of mode m's 1-D projection reference
                array (length 3N+1, logical index -N..2N at offset N),
                including the negative-angle INV_ANGLE extension;
  idx[m,y,x]  : projection index into that array
                (= N + base + 1 + ((scan+1)*angle >> 5)), already
                transposed for horizontal modes;
  frac[m,y,x] : 1/32-pel interpolation fraction.

`angular_weight_matrices` folds both into one (4N+2, N*N) matrix per
mode, the form the JAX package runs on the TPU's matrix unit.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np

from nanohevc_tpu_torch.tables import INTRA_PRED_ANGLE, INV_ANGLE


class AngularTables(NamedTuple):
    modes: Tuple[int, ...]   # angular modes covered, each in 2..34
    src: np.ndarray          # (M, 3N+1) int32 into combined refs (4N+2)
    idx: np.ndarray          # (M, N, N) int32 into the per-mode ref array
    frac: np.ndarray         # (M, N, N) int32 in 0..31


def _mode_tables(mode: int, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    angle = INTRA_PRED_ANGLE[mode - 2]
    vertical = mode >= 18
    ref_len = 2 * n + 1
    pbase = 0 if vertical else ref_len        # primary = top for vertical
    sbase = ref_len if vertical else 0

    src = np.zeros(3 * n + 1, dtype=np.int32)
    src[n] = 0                                # corner (same value at 0 and 2N+1)
    src[n + 1:] = pbase + np.arange(1, 2 * n + 1)
    if angle < 0:
        inv = INV_ANGLE[angle]
        num_extend = (n * angle) >> 5         # in [-N, -1]
        for i in range(-1, num_extend - 1, -1):
            proj = ((i + 1) * inv + 128) >> 8  # always within 0..N-1
            src[n + i] = sbase + proj

    idx = np.zeros((n, n), dtype=np.int32)
    frac = np.zeros((n, n), dtype=np.int32)
    for scan in range(n):
        proj = (scan + 1) * angle
        ip, fr = proj >> 5, proj & 31
        for base in range(n):
            y, x = (scan, base) if vertical else (base, scan)
            idx[y, x] = n + base + 1 + ip
            frac[y, x] = fr
    return src, idx, frac


@lru_cache(maxsize=None)
def angular_tables(n: int, modes: Tuple[int, ...] = tuple(range(2, 35))) -> AngularTables:
    """Build (and cache) the stacked tables for a mode set at size N."""
    srcs, idxs, fracs = zip(*(_mode_tables(m, n) for m in modes))
    return AngularTables(
        modes=modes,
        src=np.stack(srcs),
        idx=np.stack(idxs),
        frac=np.stack(fracs),
    )


@lru_cache(maxsize=None)
def angular_weight_matrices(
    n: int, modes: Tuple[int, ...] = tuple(range(2, 35))
) -> np.ndarray:
    """Per-mode dense weight matrices: pred_flat = (refs @ W_m + 16) >> 5.

    W_m (4N+2, N*N) holds the two lerp weights (32-frac at the source
    of idx, frac at the source of idx+1) routed through the src table.
    Returns (len(modes), 4N+2, N*N) int32.
    """
    tabs = angular_tables(n, modes)
    m = len(modes)
    ref_len = 3 * n + 1
    out = np.zeros((m, 4 * n + 2, n * n), np.int32)
    for mi in range(m):
        src = tabs.src[mi]
        idx = tabs.idx[mi].reshape(-1)
        frac = tabs.frac[mi].reshape(-1)
        for p in range(n * n):
            a = src[idx[p]]
            b = src[min(idx[p] + 1, ref_len - 1)]
            out[mi, a, p] += 32 - frac[p]
            out[mi, b, p] += frac[p]
    return out
