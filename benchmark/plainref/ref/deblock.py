# Frozen copy of nanohevc_tpu_torch/ref/deblock.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
# Copy of nanohevc_tpu/ref/deblock.py (only the import lines differ).
"""Numpy oracle for the HEVC in-loop deblocking filter (spec 8.7).

The reference implementation (Luodian/nano-hevc) has no in-loop
filtering at all — its README's "future work" stops at the entropy
layer.  This module is the framework's sequential, spec-shaped oracle
for the deblocking filter; the batched TPU formulation lives in
ops/deblock.py and is fuzz-checked bit-exact against this one.

Scope — the all-intra specialization of spec 8.7.2:

* Every transform-block boundary has boundary strength bS = 2 (both
  sides intra, table in 8.7.2.4), so bS never needs to be derived.
* Edges are filtered on the 8-sample deblocking grid of each plane
  (luma 8.7.2.2: x % 8 == 0; chroma likewise in chroma samples).
  With a uniform block size N, the filtered edges are the block
  boundaries that fall on that grid (all of them for N >= 8; every
  other one for N == 4).
* Picture-boundary edges are never filtered (filterEdgeFlag = 0).
* Vertical edges are filtered over the whole plane first, then
  horizontal edges read the vertically-filtered samples (8.7.2.1).
* QP is uniform over a plane (one slice per plane), so the spec's
  per-edge qP = (QpQ + QpP + 1) >> 1 is just the plane QP.  The
  framework quantizes chroma at the luma QP (no chroma QP mapping, as
  the reference's quantizer has none — reference quant.py:25-38), so
  the chroma filter strength also uses the plane's coded QP directly.

Luma decision/filter: 8.7.2.5.3 (d < beta on/off, strong/weak from
lines 0 and 3 of each 4-line segment) and 8.7.2.5.7 (3+3-tap strong
filter clipped to +-2*tc; delta weak filter with one-sided p1/q1
taps).  Chroma: 8.7.2.5.5 — p0/q0 only, no on/off decision beyond
bS == 2.  beta'/tc' from Table 8-12, scaled by 1 << (bit_depth - 8).
"""

from __future__ import annotations

import numpy as np

# Spec Table 8-12: beta' indexed by Q = clip(qp, 0, 51).
BETA_TABLE = np.array(
    [0] * 16
    + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]
    + list(range(20, 66, 2)),
    dtype=np.int32,
)
# Spec Table 8-12: tc' indexed by Q = clip(qp + 2 * (bS - 1), 0, 53);
# all-intra bS == 2 so Q = qp + 2.
TC_TABLE = np.array(
    [0] * 18
    + [1] * 9
    + [2] * 4
    + [3] * 4
    + [4] * 3
    + [5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    dtype=np.int32,
)

assert BETA_TABLE.shape == (52,)
assert TC_TABLE.shape == (54,)


def _clip3(lo, hi, v):
    return min(hi, max(lo, v))


def filter_params(qp: int, bit_depth: int = 8) -> tuple[int, int]:
    """(beta, tc) for a bS=2 edge at this QP/bit depth (8.7.2.5.3)."""
    beta = int(BETA_TABLE[_clip3(0, 51, int(qp))]) << (bit_depth - 8)
    tc = int(TC_TABLE[_clip3(0, 53, int(qp) + 2)]) << (bit_depth - 8)
    return beta, tc


def _filter_luma_segment(seg: np.ndarray, beta: int, tc: int,
                         pix_max: int) -> np.ndarray:
    """One 4-line luma edge segment: seg is (4, 8) = [p3..p0, q0..q3].

    Returns the filtered (4, 8) segment (p3/q3 never change).
    Spec 8.7.2.5.3 decisions + 8.7.2.5.7 filters, bS = 2.
    """
    s = seg.astype(np.int64)
    p = s[:, 3::-1]  # p[:, k] = p_k  (p0 nearest the edge)
    q = s[:, 4:]     # q[:, k] = q_k

    def dpq(line):
        dp = abs(int(p[line, 2]) - 2 * int(p[line, 1]) + int(p[line, 0]))
        dq = abs(int(q[line, 2]) - 2 * int(q[line, 1]) + int(q[line, 0]))
        return dp, dq

    dp0, dq0 = dpq(0)
    dp3, dq3 = dpq(3)
    d = dp0 + dq0 + dp3 + dq3
    if d >= beta:
        return seg

    def strong_at(line):
        sw = 2 * (dpq(line)[0] + dpq(line)[1]) < (beta >> 2)
        sw &= (abs(int(p[line, 3]) - int(p[line, 0]))
               + abs(int(q[line, 0]) - int(q[line, 3]))) < (beta >> 3)
        sw &= abs(int(p[line, 0]) - int(q[line, 0])) < ((5 * tc + 1) >> 1)
        return sw

    out = seg.astype(np.int64).copy()
    if strong_at(0) and strong_at(3):
        for line in range(4):
            p3, p2, p1, p0 = (int(p[line, k]) for k in (3, 2, 1, 0))
            q0, q1, q2, q3 = (int(q[line, k]) for k in (0, 1, 2, 3))
            out[line, 3] = _clip3(p0 - 2 * tc, p0 + 2 * tc,
                                  (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
            out[line, 2] = _clip3(p1 - 2 * tc, p1 + 2 * tc,
                                  (p2 + p1 + p0 + q0 + 2) >> 2)
            out[line, 1] = _clip3(p2 - 2 * tc, p2 + 2 * tc,
                                  (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
            out[line, 4] = _clip3(q0 - 2 * tc, q0 + 2 * tc,
                                  (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
            out[line, 5] = _clip3(q1 - 2 * tc, q1 + 2 * tc,
                                  (p0 + q0 + q1 + q2 + 2) >> 2)
            out[line, 6] = _clip3(q2 - 2 * tc, q2 + 2 * tc,
                                  (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)
    else:
        side_thresh = (beta + (beta >> 1)) >> 3
        filt_p1 = (dp0 + dp3) < side_thresh
        filt_q1 = (dq0 + dq3) < side_thresh
        for line in range(4):
            p2, p1, p0 = (int(p[line, k]) for k in (2, 1, 0))
            q0, q1, q2 = (int(q[line, k]) for k in (0, 1, 2))
            delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
            if abs(delta) >= tc * 10:
                continue
            delta = _clip3(-tc, tc, delta)
            out[line, 3] = _clip3(0, pix_max, p0 + delta)
            out[line, 4] = _clip3(0, pix_max, q0 - delta)
            if filt_p1:
                dp = _clip3(-(tc >> 1), tc >> 1,
                            (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)
                out[line, 2] = _clip3(0, pix_max, p1 + dp)
            if filt_q1:
                dq = _clip3(-(tc >> 1), tc >> 1,
                            (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)
                out[line, 5] = _clip3(0, pix_max, q1 + dq)
    return out.astype(seg.dtype)


def _filter_chroma_line(line: np.ndarray, tc: int, pix_max: int) -> np.ndarray:
    """One chroma edge line: (4,) = [p1, p0, q0, q1] (8.7.2.5.5)."""
    p1, p0, q0, q1 = (int(v) for v in line)
    delta = _clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
    out = line.astype(np.int64).copy()
    out[1] = _clip3(0, pix_max, p0 + delta)
    out[2] = _clip3(0, pix_max, q0 - delta)
    return out.astype(line.dtype)


def _vertical_pass(plane: np.ndarray, qp: int, bit_depth: int,
                   is_chroma: bool) -> np.ndarray:
    """Filter all interior vertical edges on the 8-sample grid."""
    h, w = plane.shape
    beta, tc = filter_params(qp, bit_depth)
    pix_max = (1 << bit_depth) - 1
    out = plane.copy()
    if tc == 0 and (is_chroma or beta == 0):
        return out
    for x in range(8, w - 3, 8):
        if is_chroma:
            for y in range(h):
                out[y, x - 2 : x + 2] = _filter_chroma_line(
                    out[y, x - 2 : x + 2], tc, pix_max
                )
        else:
            for y0 in range(0, h - 3, 4):
                out[y0 : y0 + 4, x - 4 : x + 4] = _filter_luma_segment(
                    out[y0 : y0 + 4, x - 4 : x + 4], beta, tc, pix_max
                )
    return out


def deblock_plane(plane: np.ndarray, qp: int, bit_depth: int = 8,
                  is_chroma: bool = False) -> np.ndarray:
    """Deblock one reconstructed plane (spec 8.7.2, all-intra bS = 2).

    Vertical edges over the whole plane first, then horizontal edges
    on the result (8.7.2.1's pass ordering).  The caller applies this
    to the padded (block-aligned) reconstruction before the
    conformance-window crop, identically in encoder and decoder.
    """
    plane = np.asarray(plane)
    v = _vertical_pass(plane, qp, bit_depth, is_chroma)
    return _vertical_pass(v.T, qp, bit_depth, is_chroma).T
