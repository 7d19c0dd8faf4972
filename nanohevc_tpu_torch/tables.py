# Copy of nanohevc_tpu/tables.py (only the import lines and reference paths differ).
"""Static HEVC specification tables, generated structurally.

Single source of truth for every constant table in the framework: the
integer core-transform matrices (spec Tables 8-8 / 8-9), the intra
angle tables (Table 8-4 / 8-5), the quantization scales (Table 8-10)
and the coefficient scan orders (spec 6.5.3).

Unlike the reference implementation (which hard-codes all 32 rows of
the 32x32 DCT, reference/nano_hevc/transform.py:65-135), the
matrices here are *generated* from the 32-entry first-column
coefficient set of the spec via the DCT-II cosine-folding identity:

    T_N[i][j] = sign(theta) * C[fold(theta)],   theta = i*(2j+1)*(32/N)

where cos(pi*theta/64) folds into the 65-entry half-period with
C[k] ~ quant(64*sqrt(2)*cos(pi*k/64)) being the hand-tuned spec values.
This is exact (the folding is an algebraic identity of the DCT-II);
tests/test_transform.py spot-checks generated rows against spec values.
"""

from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# Core transform matrices (spec Table 8-8, Table 8-9)
# ---------------------------------------------------------------------------

# First column of the 32x32 HEVC core transform matrix: the quantized
# magnitudes of 64*sqrt(2)*cos(pi*k/64) for k=0..31, hand-tuned by the
# standard (e.g. C[8]=83, not round(83.62)=84).
_DCT_COLUMN = np.array(
    [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
     64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4],
    dtype=np.int32,
)


def _dct_entry(theta: int) -> int:
    """Signed magnitude of cos(pi*theta/64) folded into _DCT_COLUMN."""
    r = theta % 128
    if r > 64:
        r = 128 - r            # cos(pi*(128-r)/64) == cos(pi*r/64)
    if r < 32:
        return int(_DCT_COLUMN[r])
    if r == 32:
        return 0               # cos(pi/2); never hit for valid (i, j)
    # cos negative on (32, 64]: cos(pi*r/64) == -cos(pi*(64-r)/64)
    return -int(_DCT_COLUMN[64 - r])


def make_dct_matrix(size: int) -> np.ndarray:
    """Generate the HEVC integer DCT-II matrix for size in {4, 8, 16, 32}."""
    if size not in (4, 8, 16, 32):
        raise ValueError(f"Unsupported transform size: {size}")
    step = 32 // size
    out = np.empty((size, size), dtype=np.int32)
    for i in range(size):
        for j in range(size):
            out[i, j] = _dct_entry(i * (2 * j + 1) * step)
    return out


def make_dst4_matrix() -> np.ndarray:
    """Generate the HEVC 4x4 DST-VII matrix (spec Table 8-9).

    Entries are round(256/3 * sin((2i+1)(j+1)*pi/9)); all values land
    well clear of the .5 rounding boundary so float rounding is exact.
    """
    out = np.empty((4, 4), dtype=np.int32)
    for i in range(4):
        for j in range(4):
            out[i, j] = round(
                256.0 / 3.0 * math.sin((2 * i + 1) * (j + 1) * math.pi / 9.0)
            )
    return out


DCT4 = make_dct_matrix(4)
DCT8 = make_dct_matrix(8)
DCT16 = make_dct_matrix(16)
DCT32 = make_dct_matrix(32)
DST4 = make_dst4_matrix()

_DCT_BY_SIZE = {4: DCT4, 8: DCT8, 16: DCT16, 32: DCT32}


def transform_matrix(size: int, use_dst: bool = False) -> np.ndarray:
    """Core transform matrix for a block size; DST-VII only at 4x4.

    Mirrors reference _get_transform_matrix (transform.py:138-151).
    """
    if use_dst and size == 4:
        return DST4
    if size not in _DCT_BY_SIZE:
        raise ValueError(f"Unsupported transform size: {size}")
    return _DCT_BY_SIZE[size]


# ---------------------------------------------------------------------------
# Intra angle tables (spec Table 8-4 / 8-5)
# ---------------------------------------------------------------------------

# intraPredAngle for modes 2..34 in 1/32-pel units (spec Table 8-4).
# Both directional families walk the same magnitude ramp, so generate
# from the half-ramp instead of typing the full 33-entry list:
#   modes  2..10:  +32 .. 0     (horizontal, down to pure-horizontal)
#   modes 11..18:   -2 .. -32   (horizontal negatives; 18 = -32, diagonal)
#   modes 19..26:  -26 .. 0     (vertical negatives, up to pure-vertical)
#   modes 27..34:   +2 .. +32   (vertical positives)
_RAMP = [32, 26, 21, 17, 13, 9, 5, 2, 0]

INTRA_PRED_ANGLE = (
    _RAMP                           # modes  2-10:  32, 26, ..., 2, 0
    + [-a for a in _RAMP[-2::-1]]   # modes 11-18:  -2, -5, ..., -32
    + [-a for a in _RAMP[1:]]       # modes 19-26: -26, -21, ..., -2, 0
    + _RAMP[-2::-1]                 # modes 27-34:   2, 5, ..., 32
)
assert len(INTRA_PRED_ANGLE) == 33
assert INTRA_PRED_ANGLE[10 - 2] == 0 and INTRA_PRED_ANGLE[26 - 2] == 0
assert INTRA_PRED_ANGLE[18 - 2] == -32 and INTRA_PRED_ANGLE[2 - 2] == 32

# invAngle = round(8192 / angle) for the negative angles (spec 8.4.4.2.6).
INV_ANGLE = {a: int(round(8192.0 / a)) for a in (-2, -5, -9, -13, -17, -21, -26, -32)}


def mode_angle(mode: int) -> int:
    """intraPredAngle for an angular mode in 2..34."""
    if not 2 <= mode <= 34:
        raise ValueError(f"Angular mode out of range: {mode}")
    return INTRA_PRED_ANGLE[mode - 2]


# ---------------------------------------------------------------------------
# Quantization scales (spec Table 8-10)
# ---------------------------------------------------------------------------

QUANT_SCALE = [26214, 23302, 20560, 18396, 16384, 14564]
DEQUANT_SCALE = [40, 45, 51, 57, 64, 72]


# ---------------------------------------------------------------------------
# Coefficient scan orders (spec 6.5.3)
# ---------------------------------------------------------------------------

def _diag_positions(size: int) -> list:
    """Up-right diagonal (y, x) traversal of a size x size grid."""
    pos = []
    for d in range(2 * size - 1):
        y = min(d, size - 1)
        while y >= 0 and d - y <= size - 1:
            pos.append((y, d - y))
            y -= 1
    return pos


def _horiz_positions(size: int) -> list:
    """Row-major (y, x) traversal (spec 6.5.3 horizontal scan element)."""
    return [(y, x) for y in range(size) for x in range(size)]


def _vert_positions(size: int) -> list:
    """Column-major (y, x) traversal (spec 6.5.3 vertical scan element)."""
    return [(y, x) for x in range(size) for y in range(size)]


def _group_scan_order(size: int, positions) -> np.ndarray:
    """Spec 6.5.3 two-level scan: 4x4 coefficient groups traversed in
    `positions` order, and positions inside each group in the same
    order.  For size == 4 this degenerates to the plain 4x4 scan.
    Returns int32 length size*size with packed[k] = flat[order[k]].
    """
    sub = positions(4)
    if size == 4:
        return np.array([y * 4 + x for y, x in sub], dtype=np.int32)
    order = np.empty(size * size, dtype=np.int32)
    k = 0
    for gy, gx in positions(size // 4):
        for sy, sx in sub:
            order[k] = (gy * 4 + sy) * size + (gx * 4 + sx)
            k += 1
    return order


def diag_scan_order(size: int) -> np.ndarray:
    """Spec 6.5.3 up-right diagonal scan (group-based above 4x4)."""
    return _group_scan_order(size, _diag_positions)


def horizontal_scan_order(size: int) -> np.ndarray:
    """Spec 6.5.3 horizontal scan: 4x4 groups row-major, positions
    inside each group row-major (NOT a plain raster scan above 4x4).
    Selected for near-vertical intra modes 22-30 at 4x4/8x8."""
    return _group_scan_order(size, _horiz_positions)


def vertical_scan_order(size: int) -> np.ndarray:
    """Spec 6.5.3 vertical scan: 4x4 groups column-major, positions
    inside each group column-major.  Selected for near-horizontal
    intra modes 6-14 at 4x4/8x8."""
    return _group_scan_order(size, _vert_positions)
