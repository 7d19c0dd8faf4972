"""Batched intra prediction over the block axis (and the mode axis).

Port of `nanohevc_tpu/ops/intra.py`.  Every function takes the
combined (nb, 4N+2) reference layout of `ops.tiling.extract_refs`.
DC and planar are broadcast arithmetic; an angular mode is a gather of
the two lerp operands through the static tables of
`ops.angular_tables` and one integer lerp.  The JAX package folds the
same lerp into per-mode weight matrices for the TPU's matrix unit; the
gather computes the identical integers on the CPU and the card.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from nanohevc_tpu_torch.ops.angular_tables import angular_tables

# Mode numbering follows HEVC: 0 = planar, 1 = DC, 2..34 angular.
PLANAR_MODE = 0
DC_MODE = 1
ALL_ANGULAR = tuple(range(2, 35))

# Reference-sample smoothing (spec 8.4.4.2.3): thresholds on
# min(|mode-26|, |mode-10|) per block size; 4x4 and DC never filter.
_SMOOTH_THRESH = {8: 7, 16: 1, 32: 0}


def mode_filter_flags(n: int) -> np.ndarray:
    """Static (35,) bool: which modes read [1 2 1]-filtered references.

    filterFlag = n > 4 and mode != DC and
    min(|mode-26|, |mode-10|) > thresh[n] (planar's index 0 gives
    minDist 10, so planar filters at every n >= 8).
    """
    flags = np.zeros(35, bool)
    if n == 4:
        return flags
    t = _SMOOTH_THRESH[n]
    for m in range(35):
        if m == DC_MODE:
            continue
        dist = 10 if m == PLANAR_MODE else min(abs(m - 26), abs(m - 10))
        flags[m] = dist > t
    return flags


def _split_refs(refs: torch.Tensor, n: int):
    """Combined (nb, 4N+2) -> top (nb, 2N+1), left (nb, 2N+1)."""
    return refs[:, : 2 * n + 1], refs[:, 2 * n + 1:]


def smooth_refs(refs: torch.Tensor, n: int, bit_depth: int = 8,
                strong: bool = True) -> torch.Tensor:
    """Reference-sample filter (spec 8.4.4.2.3) on the (nb, 4N+2) layout.

    Normal filter: along the path bottom-left -> corner -> top-right,
    interior samples take (prev + 2*cur + next + 2) >> 2, the corner
    averages its two path neighbours (top[1], left[1]), and the two
    path ends (top[2N], left[2N]) pass unfiltered.  At 32x32 with
    `strong`, a block whose two arms are both near-linear
    (|end + corner - 2*mid| < 1 << (bit_depth - 5)) takes the bilinear
    ramp between the corner and each arm's far end instead.
    """
    top, left = _split_refs(refs, n)
    corner = top[:, 0:1]
    fc = (left[:, 1:2] + 2 * corner + top[:, 1:2] + 2) >> 2

    def filt(arr):
        body = (arr[:, :-2] + 2 * arr[:, 1:-1] + arr[:, 2:] + 2) >> 2
        return torch.cat([fc, body, arr[:, -1:]], dim=1)

    f_top, f_left = filt(top), filt(left)
    if strong and n == 32:
        thresh = 1 << (bit_depth - 5)
        flat_t = (corner + top[:, 2 * n:] - 2 * top[:, n:n + 1]).abs() < thresh
        flat_l = (corner + left[:, 2 * n:] - 2 * left[:, n:n + 1]).abs() < thresh
        use_strong = flat_t & flat_l                               # (nb, 1)
        x = torch.arange(2 * n - 1, dtype=torch.int32,
                         device=refs.device)[None, :]              # samples 1..2N-1

        def bilinear(arr):
            end = arr[:, 2 * n:]
            ramp = ((2 * n - 1 - x) * corner + (x + 1) * end + n) >> n.bit_length()
            return torch.cat([corner, ramp, end], dim=1)

        f_top = torch.where(use_strong, bilinear(top), f_top)
        f_left = torch.where(use_strong, bilinear(left), f_left)
    return torch.cat([f_top, f_left], dim=1)


def cat_refs(refs: torch.Tensor, n: int, bit_depth: int = 8) -> torch.Tensor:
    """(nb, 4N+2) -> (nb, 2*(4N+2)): raw refs beside smoothed refs."""
    return torch.cat([refs, smooth_refs(refs, n, bit_depth)], dim=1)


def dc_predict(refs: torch.Tensor, n: int) -> torch.Tensor:
    """(nb, 4N+2) -> (nb, N, N): floor((sum top + sum left + N) / 2N)."""
    top, left = _split_refs(refs, n)
    total = top[:, 1: n + 1].sum(dim=1) + left[:, 1: n + 1].sum(dim=1)
    dc = ((total + n) // (2 * n)).to(torch.int32)
    return dc[:, None, None].expand(refs.shape[0], n, n)


def planar_predict(refs: torch.Tensor, n: int) -> torch.Tensor:
    """(nb, 4N+2) -> (nb, N, N) planar gradient (spec 8.4.4.2.4).

    As in the JAX package, top-right and bottom-left are top[N] and
    left[N] (corner-at-0 layout): the last sample of the length-N
    neighbour row, not the spec's beyond-block samples.
    """
    top, left = _split_refs(refs, n)
    top_right = top[:, n]
    bottom_left = left[:, n]
    shift = n.bit_length()  # log2(n) + 1
    x = torch.arange(n, dtype=torch.int32, device=refs.device)
    y = x
    h = (n - 1 - x)[None, None, :] * left[:, 1: n + 1, None] + (x + 1)[
        None, None, :
    ] * top_right[:, None, None]
    v = (n - 1 - y)[None, :, None] * top[:, None, 1: n + 1] + (y + 1)[
        None, :, None
    ] * bottom_left[:, None, None]
    return ((h + v + n) >> shift).to(torch.int32)


@lru_cache(maxsize=None)
def _lerp_tables(n: int, modes: tuple, routed: bool):
    """(ia, ib, frac), each (M, N*N): the refs index of the lerp's two
    operands and its fraction, per mode and pixel.

    ia = src[idx] and ib = src[min(idx+1, 3N)] compose the two static
    gathers of the JAX `_angular_from_tables` into one.  With `routed`,
    the modes that `mode_filter_flags` selects index the second
    (filtered) half of a `cat_refs` vector.
    """
    tabs = angular_tables(n, modes)
    m = len(modes)
    idx = tabs.idx.reshape(m, n * n)
    ia = np.take_along_axis(tabs.src, idx, axis=1).astype(np.int64)
    ib = np.take_along_axis(tabs.src, np.minimum(idx + 1, 3 * n),
                            axis=1).astype(np.int64)
    if routed:
        off = np.where(mode_filter_flags(n)[list(modes)], 4 * n + 2, 0)
        ia, ib = ia + off[:, None], ib + off[:, None]
    return ia, ib, tabs.frac.reshape(m, n * n).astype(np.int32)


def _angular(refs: torch.Tensor, n: int, modes: tuple,
             routed: bool = False) -> torch.Tensor:
    """Gather + lerp: (nb, R) -> (nb, M, N, N)."""
    ia, ib, frac = (torch.as_tensor(t, device=refs.device)
                    for t in _lerp_tables(n, modes, routed))
    a, b = refs[:, ia], refs[:, ib]                          # (nb, M, N*N)
    pred = ((32 - frac) * a + frac * b + 16) >> 5
    return pred.reshape(refs.shape[0], len(modes), n, n)


def angular_predict_all(refs: torch.Tensor, n: int) -> torch.Tensor:
    """All 33 angular modes at once: (nb, 4N+2) -> (nb, 33, N, N)."""
    return _angular(refs, n, ALL_ANGULAR)


def angular_predict_modes(refs: torch.Tensor, n: int, modes: Sequence[int],
                          routed: bool = False) -> torch.Tensor:
    """A static subset of angular modes: -> (nb, len(modes), N, N).

    With `routed`, refs is a (nb, 2*(4N+2)) `cat_refs` vector and each
    mode reads the raw or the filtered half per its filter flag.
    """
    return _angular(refs, n, tuple(modes), routed)


def _select(refs: torch.Tensor, pl_refs: torch.Tensor, n: int,
            mode_idx: torch.Tensor, ang_pred: torch.Tensor) -> torch.Tensor:
    sel = mode_idx[:, None, None]
    return torch.where(
        sel == PLANAR_MODE, planar_predict(pl_refs, n),
        torch.where(sel == DC_MODE, dc_predict(refs, n), ang_pred),
    )


def _by_mode(refs_in: torch.Tensor, n: int, mode_idx: torch.Tensor,
             routed: bool) -> torch.Tensor:
    """Each block's angular prediction under its own mode: (nb, N, N)."""
    ia, ib, frac = (torch.as_tensor(t, device=refs_in.device)
                    for t in _lerp_tables(n, ALL_ANGULAR, routed))
    ang = (mode_idx.long() - 2).clamp(0, 32)
    a = refs_in.gather(1, ia[ang])
    b = refs_in.gather(1, ib[ang])
    f = frac[ang]
    return (((32 - f) * a + f * b + 16) >> 5).reshape(-1, n, n)


def predict_by_mode(refs: torch.Tensor, n: int,
                    mode_idx: torch.Tensor) -> torch.Tensor:
    """Per-block mode selection: (nb, 4N+2), (nb,) -> (nb, N, N).

    mode_idx uses HEVC numbering and may differ per block.
    """
    return _select(refs, refs, n, mode_idx, _by_mode(refs, n, mode_idx, False))


def predict_by_mode_mm(refs: torch.Tensor, n: int, mode_idx: torch.Tensor,
                       smoothing: bool = False,
                       bit_depth: int = 8) -> torch.Tensor:
    """Per-block mode application with optional reference smoothing.

    The JAX function of this name runs the lerp as a one-hot matmul over
    the stacked weight matrices; here it is the same gather as
    `predict_by_mode`.  With smoothing (n > 4) each mode reads the raw
    or the filtered half of `cat_refs` per its filter flag, planar reads
    the filtered refs and DC the raw ones.
    """
    if not (smoothing and n > 4):
        return predict_by_mode(refs, n, mode_idx)
    refs_in = cat_refs(refs, n, bit_depth)
    pl_refs = refs_in[:, refs.shape[1]:] if mode_filter_flags(n)[PLANAR_MODE] else refs
    return _select(refs, pl_refs, n, mode_idx, _by_mode(refs_in, n, mode_idx, True))
