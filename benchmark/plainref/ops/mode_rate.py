# Frozen copy of nanohevc_tpu_torch/ops/mode_rate.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""MPM intra-mode rate model (spec 8.4.2.2 bin counts), port of
`nanohevc_tpu/ops/mode_rate.py`.

The mode coder spends 2 bits on MPM index 0 (prev_intra_pred_flag and
one mpm_idx bin), 3 on indexes 1 and 2, and 6 on a miss (the flag and
5 fixed rem_intra_pred_mode bins).  `mpm_mode_bits` charges every
candidate mode of a block those bits from its left and above
neighbours' modes, with the candModeList algebra of the C++ coder.
Integer work; the bits are exact float32 values.
"""

from __future__ import annotations

import torch

# Unavailable neighbours read as INTRA_DC (the spec rule).
_UNAVAIL = 1

MPM_HIT0_BITS = 2.0   # prev flag + mpm_idx bin0
MPM_HIT12_BITS = 3.0  # prev flag + 2 truncated-unary bins
MPM_MISS_BITS = 6.0   # prev flag + 5 fixed rem bins


def mpm_lists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """candModeList per spec 8.4.2.2: left modes a and above modes b,
    any shape -> (..., 3) int32."""
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b, device=a.device).to(torch.int32)
    eq_nonang = torch.stack(
        [torch.zeros_like(a), torch.ones_like(a), torch.full_like(a, 26)], -1)
    eq_ang = torch.stack([a, 2 + (a + 29) % 32, 2 + (a - 1) % 32], -1)
    eq = torch.where((a < 2)[..., None], eq_nonang, eq_ang)
    # a != b: planar if neither is planar, else DC, else vertical
    third = torch.where(
        (a != 0) & (b != 0), torch.zeros_like(a),
        torch.where(a + b < 2, torch.full_like(a, 26), torch.ones_like(a)))
    ne = torch.stack([a, b, third], -1)
    return torch.where((a == b)[..., None], eq, ne).to(torch.int32)


def mpm_mode_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(nb,) left/above neighbour modes (1 where the neighbour is
    outside the plane) -> (nb, 35) float32 signalling bits of every
    candidate mode."""
    m = mpm_lists(a, b)
    cand = torch.arange(35, dtype=torch.int32, device=m.device)[None, :]
    hit0 = cand == m[:, 0:1]
    hit12 = (cand == m[:, 1:2]) | (cand == m[:, 2:3])
    return torch.where(
        hit0, MPM_HIT0_BITS,
        torch.where(hit12, MPM_HIT12_BITS, MPM_MISS_BITS),
    ).to(torch.float32)


def neighbor_modes_grid(modes_grid: torch.Tensor):
    """Left/above neighbour mode planes of a raster (nby, nbx) grid:
    (a, b), each (nby, nbx), DC where the neighbour is outside."""
    g = torch.as_tensor(modes_grid).to(torch.int32)
    a = torch.cat([torch.full_like(g[:, :1], _UNAVAIL), g[:, :-1]], dim=1)
    b = torch.cat([torch.full_like(g[:1, :], _UNAVAIL), g[:-1, :]], dim=0)
    return a, b


def mode_bits_for_grid(modes_grid: torch.Tensor) -> torch.Tensor:
    """(nby, nbx) decided modes -> (nby*nbx, 35) candidate bits, each
    block's list from its neighbours in the given decision."""
    a, b = neighbor_modes_grid(modes_grid)
    return mpm_mode_bits(a.reshape(-1), b.reshape(-1))
