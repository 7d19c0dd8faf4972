# Frozen copy of nanohevc_tpu_torch/ops/deblock.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
"""Deblocking filter (spec 8.7.2, all-intra bS = 2), port of
`nanohevc_tpu/ops/deblock.py`.

Edges lie on the 8-sample grid and a filter touches at most 4 samples
on each side, so the edges of one pass are independent: the vertical
pass is a handful of elementwise ops over the (..., H, n_edges) views
taken with stride-8 slices, and the horizontal pass is the same
function on the transpose of its output (the spec's pass order,
8.7.2.1).  The 4-row segment decisions of 8.7.2.5.3 read rows 0 and 3
of each segment; rows past the last full segment stay unfiltered, as
in the numpy oracle `ref/deblock.py`.

All arithmetic is int32 on the device of the plane; `>>` on negatives
is arithmetic, as in XLA.  qp is a Python int or a (B,) int tensor,
one QP per plane of a (B, H, W) batch (rate-controlled sequences
decode frames of different slice QPs together).
"""

from __future__ import annotations

import torch

from plainref.ref.deblock import BETA_TABLE, TC_TABLE


def _params(qp, bit_depth: int, x: torch.Tensor):
    """(beta, tc) of a bS = 2 edge (Table 8-12, scaled to the bit
    depth): Python ints for an int qp, else int32 tensors shaped to
    broadcast over the (B, ..., H, n_e) views of x."""
    shift = bit_depth - 8
    if not isinstance(qp, torch.Tensor):
        qp = int(qp)
        return (int(BETA_TABLE[min(max(qp, 0), 51)]) << shift,
                int(TC_TABLE[min(max(qp + 2, 0), 53)]) << shift)
    qp = qp.to(device=x.device, dtype=torch.int64)
    qp = qp.reshape(qp.shape + (1,) * (x.dim() - qp.dim()))
    beta = torch.from_numpy(BETA_TABLE).to(x.device)[qp.clamp(0, 51)]
    tc = torch.from_numpy(TC_TABLE).to(x.device)[(qp + 2).clamp(0, 53)]
    return beta << shift, tc << shift


def _cols(x: torch.Tensor, start: int, n_e: int) -> torch.Tensor:
    """Column `start` of every edge's 8-sample window: (..., H, n_e)."""
    return x[..., start:start + 8 * (n_e - 1) + 1:8]


def _seg_bcast(m: torch.Tensor, h: int) -> torch.Tensor:
    """(..., H//4, n_e) per-segment mask -> (..., H, n_e) per row; tail
    rows past the last full 4-row segment are False (unfiltered)."""
    b = m.repeat_interleave(4, dim=-2)
    rem = h - b.shape[-2]
    if rem:
        pad = b.new_zeros(b.shape[:-2] + (rem, b.shape[-1]))
        b = torch.cat([b, pad], dim=-2)
    return b


def _vertical_pass(x: torch.Tensor, qp, bit_depth: int,
                   is_chroma: bool) -> torch.Tensor:
    """Filter every interior vertical edge of (..., H, W) planes."""
    h, w = x.shape[-2], x.shape[-1]
    n_e = (w - 4) // 8
    x = x.to(torch.int32)
    if n_e <= 0:
        return x
    beta, tc = _params(qp, bit_depth, x)
    pix_max = (1 << bit_depth) - 1
    x = x.clone()

    if is_chroma:
        # 8.7.2.5.5: p0/q0 only, no on/off decision beyond bS == 2.
        p1, p0, q0, q1 = (_cols(x, j, n_e) for j in (6, 7, 8, 9))
        delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
        new_p0 = (p0 + delta).clamp(0, pix_max)
        new_q0 = (q0 - delta).clamp(0, pix_max)
        x[..., 7:7 + 8 * (n_e - 1) + 1:8] = new_p0
        x[..., 8:8 + 8 * (n_e - 1) + 1:8] = new_q0
        return x

    p3, p2, p1, p0, q0, q1, q2, q3 = (_cols(x, 4 + j, n_e) for j in range(8))
    hs = h // 4
    if hs == 0:
        return x
    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()

    def seg(a, i):  # row i of every 4-row segment: (..., H//4, n_e)
        return a[..., :4 * hs, :][..., i::4, :]

    dp03 = seg(dp, 0) + seg(dp, 3)
    dq03 = seg(dq, 0) + seg(dq, 3)
    on = (dp03 + dq03) < beta                        # 8.7.2.5.3 d < beta

    def strong_at(i):
        sw = 2 * (seg(dp, i) + seg(dq, i)) < (beta >> 2)
        sw &= ((seg(p3, i) - seg(p0, i)).abs()
               + (seg(q0, i) - seg(q3, i)).abs()) < (beta >> 3)
        sw &= (seg(p0, i) - seg(q0, i)).abs() < ((5 * tc + 1) >> 1)
        return sw

    strong = _seg_bcast(on & strong_at(0) & strong_at(3), h)
    weak = _seg_bcast(on, h) & ~strong
    side = (beta + (beta >> 1)) >> 3
    filt_p1 = weak & _seg_bcast(dp03 < side, h)
    filt_q1 = weak & _seg_bcast(dq03 < side, h)

    # Strong filter (8.7.2.5.7), clipped to +-2*tc around the input.
    c2 = 2 * tc
    p0s = torch.clamp((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      p0 - c2, p0 + c2)
    p1s = torch.clamp((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2)
    p2s = torch.clamp((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                      p2 - c2, p2 + c2)
    q0s = torch.clamp((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                      q0 - c2, q0 + c2)
    q1s = torch.clamp((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2, q1 + c2)
    q2s = torch.clamp((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                      q2 - c2, q2 + c2)

    # Weak filter: per-row delta, dead when |delta| >= 10*tc.
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wok = weak & (delta.abs() < 10 * tc)
    dc = torch.clamp(delta, -tc, tc)
    p0w = (p0 + dc).clamp(0, pix_max)
    q0w = (q0 - dc).clamp(0, pix_max)
    th = tc >> 1
    p1w = (p1 + torch.clamp((((p2 + p0 + 1) >> 1) - p1 + dc) >> 1, -th, th)
           ).clamp(0, pix_max)
    q1w = (q1 + torch.clamp((((q2 + q0 + 1) >> 1) - q1 - dc) >> 1, -th, th)
           ).clamp(0, pix_max)

    new = {
        1: torch.where(strong, p2s, p2),
        2: torch.where(strong, p1s, torch.where(wok & filt_p1, p1w, p1)),
        3: torch.where(strong, p0s, torch.where(wok, p0w, p0)),
        4: torch.where(strong, q0s, torch.where(wok, q0w, q0)),
        5: torch.where(strong, q1s, torch.where(wok & filt_q1, q1w, q1)),
        6: torch.where(strong, q2s, q2),
    }
    for j, col in new.items():
        x[..., 4 + j:4 + j + 8 * (n_e - 1) + 1:8] = col
    return x


def deblock_plane(plane: torch.Tensor, qp, bit_depth: int = 8,
                  is_chroma: bool = False) -> torch.Tensor:
    """Deblock (..., H, W) reconstructed planes -> int32, same shape.

    Applied to the padded (block-aligned) reconstruction before the
    conformance-window crop, identically by encoder and decoder, so the
    closed loop's decode stays pixel-exact.  qp: a Python int, or a
    (B,) tensor for (B, H, W) planes.
    """
    v = _vertical_pass(plane, qp, bit_depth, is_chroma)
    return _vertical_pass(v.transpose(-1, -2), qp, bit_depth,
                          is_chroma).transpose(-1, -2)
