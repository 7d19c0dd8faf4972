# Frozen copy of nanohevc_tpu_torch/ref/sao.py for the benchmark's plain reference
# (only the import lines differ); later changes to the port do not reach it.
# Copy of nanohevc_tpu/ref/sao.py (only the import lines differ).
"""Numpy oracle for Sample Adaptive Offset (HEVC spec 8.7.3).

Second in-loop filter, applied after deblocking to the output
reconstruction (intra prediction reads pre-SAO samples, so this is an
output-only stage like ref/deblock.py and round trips stay
pixel-exact).  The reference implementation has no in-loop filtering
at all; this is a framework capability beyond it.

Framework adaptation: HEVC signals SAO per CTB with merge flags; this
framework adapts ONE parameter set per plane per frame (type, band
position, four offsets), carried in a per-frame SAO NAL.  The sample
classification and offset math below follow the spec exactly:

* Edge offset (EO), classes 0-3 = 0/90/135/45 degrees: category from
  edgeIdx = 2 + Sign(c - n0) + Sign(c - n1), remapped so local
  minima/maxima are categories 1/4 and concave/convex edges 2/3
  (spec 8.7.3's bandTable/edgeIdx derivation).  Samples whose
  neighbor lies outside the picture keep category 0 (unfiltered).
* Band offset (BO): bandIdx = p >> (bitDepth - 5) (32 bands); the
  four consecutive bands starting at band_pos (mod 32, the spec's
  (sao_band_position + k) & 31) receive the four offsets.
* Offset magnitude cap: (1 << (min(bitDepth, 10) - 5)) - 1
  (7 at 8-bit); EO categories 1/2 are non-negative, 3/4 non-positive
  (the spec's inferred EO offset signs).

Encoder-side estimation picks, per plane, the candidate (off, 4 EO
classes, best-position BO) with the lowest exact SSE delta
cnt*o^2 - 2*o*sum per category; see estimate_sao.  Estimation
arithmetic is pinned to int32 sums + float32 scoring so the batched
device implementation (ops/sao.py) is bit-identical.
"""

from __future__ import annotations

import numpy as np

# (dy0, dx0, dy1, dx1) neighbor offsets per EO class 0..3
EO_NEIGHBORS = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (-1, 1, 1, -1))

# edgeIdx (0..4, = 2 + sign sum) -> SAO category
EDGE_CAT = np.array([1, 2, 0, 3, 4], dtype=np.int32)

SAO_OFF = 0       # type indices carried in the SAO NAL
SAO_EO0 = 1       # .. SAO_EO3 = 4
SAO_BO = 5


def max_offset(bit_depth: int) -> int:
    return (1 << (min(bit_depth, 10) - 5)) - 1


def eo_categories(plane: np.ndarray, eo_class: int) -> np.ndarray:
    """(H, W) int32 SAO category per sample for one EO class.

    Border samples whose neighbor falls outside the picture get 0.
    """
    h, w = plane.shape
    p = plane.astype(np.int64)
    dy0, dx0, dy1, dx1 = EO_NEIGHBORS[eo_class]
    cat = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            y0, x0, y1, x1 = y + dy0, x + dx0, y + dy1, x + dx1
            if not (0 <= y0 < h and 0 <= x0 < w
                    and 0 <= y1 < h and 0 <= x1 < w):
                continue
            ei = 2 + np.sign(p[y, x] - p[y0, x0]) + np.sign(p[y, x] - p[y1, x1])
            cat[y, x] = EDGE_CAT[int(ei)]
    return cat


def band_indices(plane: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """(H, W) int32 band index 0..31 (spec: p >> (bitDepth - 5))."""
    return (plane.astype(np.int32) >> (bit_depth - 5)).astype(np.int32)


def apply_sao(plane: np.ndarray, type_idx: int, band_pos: int,
              offsets, bit_depth: int = 8) -> np.ndarray:
    """Apply one plane's SAO parameters (decoder side, 8.7.3.2)."""
    plane = np.asarray(plane)
    offsets = np.asarray(offsets, np.int32)
    pix_max = (1 << bit_depth) - 1
    if type_idx == SAO_OFF:
        return plane.copy()
    if type_idx == SAO_BO:
        lut = np.zeros(32, np.int32)
        for k in range(4):
            lut[(band_pos + k) & 31] = offsets[k]
        delta = lut[band_indices(plane, bit_depth)]
    else:
        cat = eo_categories(plane, type_idx - 1)
        lut = np.concatenate([[0], offsets]).astype(np.int32)
        delta = lut[cat]
    return np.clip(plane.astype(np.int32) + delta, 0, pix_max).astype(
        plane.dtype
    )


def _offset_from_stats(cnt: np.ndarray, ssum: np.ndarray, cap: int,
                       lo: int, hi: int) -> np.ndarray:
    """round(sum/cnt) clipped to [lo, hi] within +-cap; 0 where cnt==0.

    float32 division + numpy round (half-even), identical to the
    device implementation so decisions match bit-for-bit.
    """
    cnt = np.asarray(cnt, np.int32)
    ssum = np.asarray(ssum, np.int32)
    o = np.round(ssum.astype(np.float32) / np.maximum(cnt, 1).astype(np.float32))
    o = np.clip(o.astype(np.int32), max(lo, -cap), min(hi, cap))
    return np.where(cnt > 0, o, 0).astype(np.int32)


def _delta_sse(cnt, ssum, o) -> np.ndarray:
    """SSE change from adding o to every sample of a category:
    sum((d-o)^2 - d^2) = cnt*o^2 - 2*o*sum, scored in float32."""
    cnt = np.asarray(cnt, np.float32)
    ssum = np.asarray(ssum, np.float32)
    o = np.asarray(o, np.float32)
    return cnt * (o * o) - np.float32(2.0) * o * ssum


def estimate_sao(src: np.ndarray, rec: np.ndarray,
                 bit_depth: int = 8) -> tuple[int, int, np.ndarray]:
    """Pick (type_idx, band_pos, offsets[4]) minimizing the SSE delta.

    Candidates: off (delta 0), the four EO classes, and BO at its best
    band position.  diff = src - rec per category; the optimal offset
    is round(mean diff) under the spec's cap and EO sign constraints.
    """
    src = np.asarray(src, np.int32)
    rec = np.asarray(rec, np.int32)
    diff = src - rec
    cap = max_offset(bit_depth)

    best = (np.float32(0.0), SAO_OFF, 0, np.zeros(4, np.int32))
    for c in range(4):
        cat = eo_categories(rec, c)
        offs = np.zeros(4, np.int32)
        d_total = np.float32(0.0)
        for k in range(1, 5):
            m = cat == k
            cnt = np.int32(m.sum())
            ssum = np.int32(diff[m].sum(dtype=np.int32))
            lo, hi = (0, cap) if k <= 2 else (-cap, 0)
            o = _offset_from_stats(cnt, ssum, cap, lo, hi)
            offs[k - 1] = o
            d_total += _delta_sse(cnt, ssum, o)
        if d_total < best[0]:
            best = (d_total, SAO_EO0 + c, 0, offs)

    bands = band_indices(rec, bit_depth)
    cnt_b = np.zeros(32, np.int32)
    sum_b = np.zeros(32, np.int32)
    for b in range(32):
        m = bands == b
        cnt_b[b] = m.sum()
        sum_b[b] = diff[m].sum(dtype=np.int32)
    o_b = _offset_from_stats(cnt_b, sum_b, cap, -cap, cap)
    d_b = _delta_sse(cnt_b, sum_b, o_b)
    for pos in range(29):               # encoder uses non-wrapping windows
        # explicit left-to-right chain: the device twin adds in the
        # same order, keeping float32 scores bit-identical
        d_total = ((d_b[pos] + d_b[pos + 1]) + d_b[pos + 2]) + d_b[pos + 3]
        if d_total < best[0]:
            best = (d_total, SAO_BO, pos, o_b[pos : pos + 4].copy())
    return best[1], best[2], best[3]
