"""Batched DC and planar intra prediction over the block axis.

Port of the DC/planar part of `nanohevc_tpu/ops/intra.py`.  Both take
the combined (nb, 4N+2) reference layout of `ops.tiling.extract_refs`.
Angular modes and reference smoothing are not ported yet.
"""

from __future__ import annotations

import torch

# Mode numbering follows HEVC: 0 = planar, 1 = DC, 2..34 angular.
PLANAR_MODE = 0
DC_MODE = 1


def _split_refs(refs: torch.Tensor, n: int):
    """Combined (nb, 4N+2) -> top (nb, 2N+1), left (nb, 2N+1)."""
    return refs[:, : 2 * n + 1], refs[:, 2 * n + 1:]


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
