"""The frame bitstream in plain Python: what the port's host runtime
(`runtime/bitstream.py` over the g++ codecs `runtime/native/
nanohevc_runtime.cpp` and `hevc_cabac.cpp`) must write for the
configurations the benchmark runs: closed loop, scan "mode", CTB SAO,
entropy coder "cabac".

Layout: VPS, SPS and PPS parameter sets (exp-Golomb fields), the CTB
SAO NAL, then a slice NAL a plane (Y, U, V): a 20-byte header, the
modes by MPM prediction through the adaptive binary range coder (with
a 4-lane hash of the modes), and the levels in the spec 9.3 CABAC
engine with the 7.3.8.11 residual_coding syntax.  Every NAL carries a
start code, a 2-byte header and emulation prevention.
"""

from __future__ import annotations

import struct

import numpy as np

from plainref import tables
from plainref.ref.sao import SAO_BO, SAO_OFF

NAL_VPS, NAL_SPS, NAL_PPS, NAL_SLICE, NAL_SAO = 32, 33, 34, 1, 39
SCAN_IDX = {"diag": 0, "horizontal": 1, "vertical": 2, "mode": 3}
ENTROPY_IDX = {"range": 0, "cabac": 1, "hevc-slice": 2}
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


# --- framing ------------------------------------------------------------------

class BitWriter:
    """MSB-first bits with exp-Golomb ue(v) and rbsp trailing bits."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, width: int) -> None:
        self.bits.extend((value >> i) & 1 for i in range(width - 1, -1, -1))

    def put_ue(self, v: int) -> None:
        x = v + 1
        n = x.bit_length() - 1
        self.bits.extend([0] * n)
        self.put(x, n + 1)

    def to_bytes(self) -> bytes:
        pad = -len(self.bits) % 8
        return np.packbits(np.array(self.bits + [0] * pad, np.uint8)).tobytes()


def write_params(width: int, height: int, block_size: int, qp: int,
                 which: int, *, bit_depth: int, scan_idx: int,
                 rescale_flag: int, smoothing_flag: int, entropy_idx: int,
                 deblock_flag: int, mode_mpm_flag: int, sao_flag: int) -> bytes:
    """Parameter-set payload: 0 VPS, 1 SPS, 2 PPS."""
    bw = BitWriter()
    bw.put(0x4E48, 16)
    bw.put(which, 8)
    if which == 0:
        fields = (2, 0)
    elif which == 1:
        fields = (width, height, block_size, 1, bit_depth - 8)
    else:
        fields = (qp, scan_idx, rescale_flag, smoothing_flag, entropy_idx,
                  deblock_flag, mode_mpm_flag, sao_flag)
    for v in fields:
        bw.put_ue(v)
    bw.bits.append(1)
    return bw.to_bytes()


def wrap_nal(nal_type: int, payload: bytes) -> bytes:
    """Start code, NAL header, payload with emulation-prevention bytes."""
    out = bytearray(b"\x00\x00\x00\x01")
    out += bytes([(nal_type & 0x3F) << 1, 1])
    zeros = 0
    for b in payload:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def write_sao_ctb_params(sao_ctb: dict, bit_depth: int) -> bytes:
    """The CTB SAO NAL payload: "NC", a plane count, then per plane a
    header and the tiles in raster order (merge left, merge up, else
    type, class or band, four offsets), merges by equality of the
    final parameters."""
    plane_ids = {"Y": 0, "U": 1, "V": 2}
    off_w = min(bit_depth, 10) - 4
    out = [b"NC", struct.pack("<B", len(sao_ctb))]
    for name, (tile, tmap, bmap, omap) in sao_ctb.items():
        tmap = np.asarray(tmap, np.int64)
        bmap = np.asarray(bmap, np.int64)
        omap = np.asarray(omap, np.int64)
        nty, ntx = tmap.shape

        def params(ty, tx):
            return (int(tmap[ty, tx]), int(bmap[ty, tx]),
                    tuple(int(v) for v in omap[ty, tx]))

        bw = BitWriter()
        for ty in range(nty):
            for tx in range(ntx):
                cur = params(ty, tx)
                if tx > 0:
                    if cur == params(ty, tx - 1):
                        bw.put(1, 1)
                        continue
                    bw.put(0, 1)
                if ty > 0:
                    if cur == params(ty - 1, tx):
                        bw.put(1, 1)
                        continue
                    bw.put(0, 1)
                t, pos, offs = cur
                if t == SAO_OFF:
                    bw.put(0, 2)
                    continue
                if t == SAO_BO:
                    bw.put(2, 2)
                    bw.put(pos, 5)
                else:
                    bw.put(1, 2)
                    bw.put(t - 1, 2)
                for o in offs:
                    bw.put(o & ((1 << off_w) - 1), off_w)
        payload = bw.to_bytes()
        out.append(struct.pack("<BBHHBI", plane_ids[name],
                               tile.bit_length() - 1, nty, ntx, off_w,
                               len(payload)))
        out.append(payload)
    return b"".join(out)


# --- the modes: MPM prediction through the adaptive range coder ---------------

def level_hash(values: np.ndarray) -> int:
    """The runtime's 4-lane multiplicative hash of int32 values."""
    mul = 0x9E3779B97F4A7C15
    h = [0x243F6A8885A308D3, 0x13198A2E03707344, 0xA4093822299F31D0,
         0x082EFA98EC4E6C89]
    v = [int(x) & _MASK32 for x in np.asarray(values).reshape(-1)]
    for i, x in enumerate(v):
        lane = i & 3 if i < len(v) - len(v) % 4 else i - (len(v) - len(v) % 4)
        h[lane] = ((h[lane] ^ x) * mul) & _MASK64
    x = h[0]
    for lane in range(1, 4):
        x = ((x ^ h[lane] ^ (h[lane] >> 29)) * mul) & _MASK64
    x ^= x >> 32
    x = (x * mul) & _MASK64
    return (x ^ (x >> 29)) & _MASK32


class RangeEncoder:
    """Byte-oriented binary range coder with carry propagation and
    15-bit adaptive probabilities (shift 5)."""

    def __init__(self):
        self.out = bytearray()
        self.low, self.range = 0, _MASK32
        self.cache, self.pending, self.first = 0, 0, True

    def encode(self, probs: list, i: int, bit: int) -> None:
        p1 = probs[i]
        r1 = (self.range * p1) >> 15
        if r1 == 0:
            r1 = 1
        if r1 >= self.range:
            r1 = self.range - 1
        if bit:
            self.range = r1
            probs[i] = p1 + ((32768 - p1) >> 5)
        else:
            self.low += r1
            self.range -= r1
            probs[i] = p1 - (p1 >> 5)
        while self.range < (1 << 24):
            self._shift_low()
            self.range = (self.range << 8) & _MASK32

    def _shift_low(self) -> None:
        low = self.low
        if (low & _MASK32) < 0xFF000000 or (low >> 32):
            carry = (low >> 32) & 0xFF
            if not self.first:
                self.out.append((self.cache + carry) & 0xFF)
            self.first = False
            while self.pending:
                self.out.append((0xFF + carry) & 0xFF)
                self.pending -= 1
            self.cache = (low >> 24) & 0xFF
        else:
            self.pending += 1
        self.low = (low << 8) & _MASK32

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


def mpm_list(a: int, b: int) -> tuple:
    """candModeList (spec 8.4.2.2) of left mode a and above mode b."""
    if a == b:
        if a < 2:
            return 0, 1, 26
        return a, 2 + ((a + 29) % 32), 2 + ((a - 1) % 32)
    if a != 0 and b != 0:
        return a, b, 0
    return a, b, 26 if a + b < 2 else 1


def encode_modes(modes: np.ndarray, nby: int, nbx: int) -> bytes:
    """(nby*nbx,) raster modes -> the range-coded MPM syntax, then the
    modes' hash (4 bytes, little-endian)."""
    m = [int(x) for x in np.asarray(modes).reshape(-1)]
    if len(m) != nby * nbx or min(m, default=0) < 0 or max(m, default=0) > 34:
        raise ValueError("modes must be nby*nbx values in [0, 34]")
    enc = RangeEncoder()
    probs = [16384] * 8          # flag, idx0, idx1, rem bits 0-4
    for y in range(nby):
        for x in range(nbx):
            i = y * nbx + x
            mode = m[i]
            cand = mpm_list(m[i - 1] if x else 1, m[i - nbx] if y else 1)
            idx = cand.index(mode) if mode in cand else -1
            enc.encode(probs, 0, idx >= 0)
            if idx >= 0:
                enc.encode(probs, 1, idx > 0)
                if idx > 0:
                    enc.encode(probs, 2, idx - 1)
            else:
                rem = mode - sum(mode > s for s in cand)
                for k in range(4, -1, -1):
                    enc.encode(probs, 3 + k, (rem >> k) & 1)
    return enc.finish() + struct.pack("<I", level_hash(np.asarray(m)))


# --- the levels: CABAC (spec 9.3) with residual_coding (7.3.8.11) -------------

_RANGE_LPS = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99),
    (56, 69, 81, 94), (53, 65, 77, 89), (51, 62, 73, 85),
    (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62),
    (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (28, 35, 41, 48), (27, 33, 39, 45),
    (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33),
    (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28),
    (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24),
    (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18),
    (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15),
    (9, 11, 12, 14), (8, 10, 12, 14), (8, 9, 11, 13),
    (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2),
)
_TRANS_LPS = (
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 23, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
)
_INIT_LAST = (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143,
              127, 111, 79, 108, 123, 63)
_INIT_SIG = (
    111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
    125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
    139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111,
)
_INIT_GT1 = (140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139,
             107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197)
_INIT_GT2 = (138, 153, 136, 167, 152, 152)
# Context slots: cbf luma, cbf chroma, last x (18), last y (18), coded
# sub-block flags (4), sig (42), greater-1 (24), greater-2 (6).
CBF, LAST_X, LAST_Y, CSBF, SIG, GT1, GT2 = 0, 2, 20, 38, 42, 84, 108
_INITS = ((111, 94) + _INIT_LAST + _INIT_LAST + (91, 171, 134, 141)
          + _INIT_SIG + _INIT_GT1 + _INIT_GT2)
_SIG_4X4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)


def _init_ctx(init: int, qp: int) -> tuple:
    slope = (init >> 4) * 5 - 45
    offset = ((init & 15) << 3) - 16
    pre = ((slope * min(max(qp, 0), 51)) >> 4) + offset
    pre = min(max(pre, 1), 126)
    mps = int(pre > 63)
    return (pre - 64 if mps else 63 - pre), mps


class CabacEncoder:
    """The spec 9.3 arithmetic encoder, bit-level output."""

    def __init__(self, qp: int):
        ctx = [_init_ctx(v, qp) for v in _INITS]
        self.state = [s for s, _ in ctx]
        self.mps = [m for _, m in ctx]
        self.low, self.range, self.outstanding = 0, 510, 0
        self.first = True
        self.bits = []

    def _put_bit(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self.bits.append(b)
        if self.outstanding:
            self.bits.extend([1 - b] * self.outstanding)
            self.outstanding = 0

    def _renorm(self) -> None:
        low, rng = self.low, self.range
        while rng < 256:
            if low < 256:
                self._put_bit(0)
            elif low >= 512:
                low -= 512
                self._put_bit(1)
            else:
                low -= 256
                self.outstanding += 1
            rng <<= 1
            low <<= 1
        self.low, self.range = low, rng

    def encode(self, ci: int, bit: int) -> None:
        s = self.state[ci]
        lps = _RANGE_LPS[s][(self.range >> 6) & 3]
        self.range -= lps
        if bit != self.mps[ci]:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ci] ^= 1
            self.state[ci] = _TRANS_LPS[s]
        else:
            self.state[ci] = s + 1 if s < 62 else s
        if self.range < 256:
            self._renorm()

    def bypass(self, bit: int) -> None:
        low = (self.low << 1) + (self.range if bit else 0)
        if low >= 1024:
            self._put_bit(1)
            low -= 1024
        elif low < 512:
            self._put_bit(0)
        else:
            low -= 512
            self.outstanding += 1
        self.low = low

    def bypass_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bypass((v >> i) & 1)

    def terminate(self, bit: int) -> None:
        self.range -= 2
        if bit:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put_bit((self.low >> 9) & 1)
            tail = ((self.low >> 7) & 3) | 1
            self.bits.extend(((tail >> 1) & 1, tail & 1))
        elif self.range < 256:
            self._renorm()

    def to_bytes(self) -> bytes:
        pad = -len(self.bits) % 8
        return np.packbits(np.array(self.bits + [0] * pad, np.uint8)).tobytes()


def _scan_pos(scan_idx: int, size: int) -> list:
    """(x, y) of each position of a size x size group in scan order."""
    if scan_idx == 0:
        return [(t - y, y) for t in range(2 * size - 1)
                for y in range(min(t, size - 1), -1, -1) if t - y < size]
    if scan_idx == 1:
        return [(x, y) for y in range(size) for x in range(size)]
    return [(x, y) for x in range(size) for y in range(size)]


_COEF_XY = {}


def _coef_xy(lg2: int, scan_idx: int) -> list:
    """Raster index of each scan position k of an N x N block: 4x4
    sub-blocks in the scan's order, positions inside each likewise."""
    key = (lg2, scan_idx)
    if key not in _COEF_XY:
        size = 1 << lg2
        sub = _scan_pos(scan_idx, size >> 2) if lg2 > 2 else [(0, 0)]
        inner = _scan_pos(scan_idx, 4)
        _COEF_XY[key] = [((ys << 2) + yp) * size + (xs << 2) + xp
                         for xs, ys in sub for xp, yp in inner]
    return _COEF_XY[key]


def _group_of(pos: int) -> int:
    if pos < 4:
        return pos
    g = 4
    while True:
        base = (2 + (g & 1)) << ((g >> 1) - 1)
        nxt = (2 + ((g + 1) & 1)) << (((g + 1) >> 1) - 1)
        if base <= pos < nxt:
            return g
        g += 1


def _sig_ctx(x: int, y: int, lg2: int, c_idx: int, prev_csbf: int,
             scan_idx: int) -> int:
    if lg2 == 2:
        s = _SIG_4X4[(y << 2) + x]
        return s if c_idx == 0 else 27 + s
    if x == 0 and y == 0:
        return 0 if c_idx == 0 else 27
    xp, yp = x & 3, y & 3
    if prev_csbf == 0:
        s = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
    elif prev_csbf == 1:
        s = 2 if yp == 0 else (1 if yp == 1 else 0)
    elif prev_csbf == 2:
        s = 2 if xp == 0 else (1 if xp == 1 else 0)
    else:
        s = 2
    if c_idx == 0:
        if (x >> 2) + (y >> 2) > 0:
            s += 3
        return s + ((9 if scan_idx == 0 else 15) if lg2 == 3 else 21)
    return 27 + s + (9 if lg2 == 3 else 12)


def _encode_last(enc: CabacEncoder, lx: int, ly: int, lg2: int, c_idx: int,
                 scan_idx: int) -> None:
    if scan_idx == 2:
        lx, ly = ly, lx
    g_max = (lg2 << 1) - 1
    gx, gy = _group_of(lx), _group_of(ly)
    if c_idx == 0:
        offset, shift = 3 * (lg2 - 2) + ((lg2 - 1) >> 2), (lg2 + 1) >> 2
    else:
        offset, shift = 15, lg2 - 2
    for base, g in ((LAST_X, gx), (LAST_Y, gy)):
        for b in range(g_max):
            enc.encode(base + offset + (b >> shift), int(b < g))
            if b >= g:
                break
    for g, v in ((gx, lx), (gy, ly)):
        if g > 3:
            nbits = (g >> 1) - 1
            enc.bypass_bits(v - ((2 + (g & 1)) << nbits), nbits)


def _encode_remaining(enc: CabacEncoder, value: int, rice: int) -> None:
    if value < (3 << rice):
        q = value >> rice
        for _ in range(q):
            enc.bypass(1)
        enc.bypass(0)
        if rice:
            enc.bypass_bits(value & ((1 << rice) - 1), rice)
        return
    v = value - (3 << rice)
    k = rice
    while v >= (1 << k):
        v -= 1 << k
        k += 1
    for _ in range(3 + k - rice):
        enc.bypass(1)
    enc.bypass(0)
    enc.bypass_bits(v, k)


def _residual(enc: CabacEncoder, c: list, lg2: int, c_idx: int,
              scan_idx: int) -> None:
    """residual_coding of one block's raster levels `c` (one nonzero at
    least), without sign hiding."""
    xy = _coef_xy(lg2, scan_idx)
    size = 1 << lg2
    ng = max(size >> 2, 1)
    n_sub = ng * ng
    last = max(k for k in range(size * size) if c[xy[k]])
    lx, ly = xy[last] % size, xy[last] // size
    _encode_last(enc, lx, ly, lg2, c_idx, scan_idx)
    sub = _scan_pos(scan_idx, ng) if lg2 > 2 else [(0, 0)]
    csbf = {}
    for sb in range(n_sub):
        if any(c[xy[(sb << 4) + i]] for i in range(16)):
            csbf[sub[sb]] = 1
    last_sub = 0 if lg2 == 2 else last >> 4
    prev_c1 = 1
    for sb in range(last_sub, -1, -1):
        xs, ys = sub[sb]
        right = csbf.get((xs + 1, ys), 0)
        below = csbf.get((xs, ys + 1), 0)
        coded = csbf.get((xs, ys), 0)
        infer_dc = 0
        if 0 < sb < last_sub:
            enc.encode(CSBF + int(bool(right or below)) + (2 if c_idx else 0),
                       coded)
            infer_dc = 1
        else:
            coded = 1
        if not coded:
            continue
        prev_csbf = right | (below << 1)
        first = sb << 4
        start = last if sb == last_sub else first + 15
        sig_pos = []
        n_coded = 0
        for k in range(start, first - 1, -1):
            v = c[xy[k]]
            if k == last:
                pass
            elif (k & 15) == 0 and infer_dc and n_coded == 0 and sb > 0:
                pass
            else:
                r = xy[k]
                enc.encode(SIG + _sig_ctx(r % size, r // size, lg2, c_idx,
                                          prev_csbf, scan_idx), int(v != 0))
                if v:
                    n_coded += 1
            if v:
                sig_pos.append(k)
        ctx_set = 2 if (sb > 0 and c_idx == 0) else 0
        if prev_c1 == 0:
            ctx_set += 1
        c1 = 1
        n_gt1 = min(len(sig_pos), 8)
        first_gt1 = -1
        vals = [c[xy[k]] for k in sig_pos]
        absv = [abs(v) for v in vals]
        for i in range(n_gt1):
            gt1 = absv[i] > 1
            enc.encode(GT1 + (16 if c_idx else 0) + ctx_set * 4 + c1, int(gt1))
            if gt1:
                c1 = 0
                if first_gt1 < 0:
                    first_gt1 = i
            elif 0 < c1 < 3:
                c1 += 1
        prev_c1 = c1
        if first_gt1 >= 0:
            enc.encode(GT2 + (4 if c_idx else 0) + ctx_set,
                       int(absv[first_gt1] > 2))
        for v in vals:
            enc.bypass(int(v < 0))
        rice = 0
        for i, a in enumerate(absv):
            base = 1 if i >= n_gt1 else (3 if i == first_gt1 else 2)
            if a >= base:
                _encode_remaining(enc, a - base, rice)
                if a > (3 << rice) and rice < 4:
                    rice += 1


def encode_plane_cabac(raster: np.ndarray, sel: np.ndarray, c_idx: int,
                       qp: int) -> bytes:
    """(nb, N, N) raster levels and per-block scanIdx -> the plane's
    CABAC payload: a coded-block flag a block, its residual where set,
    and end_of_slice (terminate) after each block."""
    nb, n, _ = raster.shape
    lg2 = n.bit_length() - 1
    enc = CabacEncoder(qp)
    flat = raster.reshape(nb, n * n)
    coded = flat.any(axis=1)
    cbf = CBF + (1 if c_idx else 0)
    rows = flat.tolist()
    for b in range(nb):
        enc.encode(cbf, int(coded[b]))
        if coded[b]:
            _residual(enc, rows[b], lg2, c_idx, int(sel[b]))
        enc.terminate(1 if b + 1 == nb else 0)
    if nb == 0:
        enc.terminate(1)
    return enc.to_bytes()


# --- the frame ----------------------------------------------------------------

def _scan_orders(n: int) -> np.ndarray:
    return np.stack([tables.diag_scan_order(n), tables.horizontal_scan_order(n),
                     tables.vertical_scan_order(n)]).astype(np.int64)


def mode_scan_idx(modes: np.ndarray, n: int) -> np.ndarray:
    """Spec 7.4.9.11 scanIdx a block: at 4x4 and 8x8 vertical for modes
    6-14, horizontal for 22-30, else diagonal."""
    modes = np.asarray(modes)
    sel = np.zeros(modes.shape, np.int64)
    if n in (4, 8):
        sel[(modes >= 6) & (modes <= 14)] = 2
        sel[(modes >= 22) & (modes <= 30)] = 1
    return sel


def mode_grid(nb: int, width: int, height: int, n: int, plane_id: int):
    pw, ph = (width, height) if plane_id == 0 else ((width + 1) // 2,
                                                    (height + 1) // 2)
    for gy, gx in ((-(-ph // n), -(-pw // n)), (ph // n, pw // n)):
        if gy * gx == nb:
            return gy, gx
    return None


def assemble(width: int, height: int, cfg: dict, levels: dict, modes: dict,
             sao_ctb: dict) -> bytes:
    """The frame's bitstream under configuration `cfg` (the keys of
    `EncoderConfig`) from each plane's scan-packed levels, modes and CTB
    SAO parameters, in the shapes `encoder.encode_frames` gives them."""
    qp, bd = int(cfg["qp"]), int(cfg["bit_depth"])
    scan = cfg["scan"]
    pk = dict(bit_depth=bd, scan_idx=SCAN_IDX[scan],
              rescale_flag=int(cfg["dequant_rescale"]),
              smoothing_flag=int(cfg["intra_smoothing"]),
              entropy_idx=ENTROPY_IDX[cfg["entropy_coder"]],
              deblock_flag=int(cfg["deblock"]), mode_mpm_flag=1,
              sao_flag=int(bool(sao_ctb)))
    if cfg["entropy_coder"] != "cabac":
        raise ValueError("the plain bitstream covers entropy_coder 'cabac'")
    first_n = levels["Y"][1]
    out = [wrap_nal(t, write_params(width, height, first_n, qp, w, **pk))
           for w, t in enumerate((NAL_VPS, NAL_SPS, NAL_PPS))]
    out.append(wrap_nal(NAL_SAO, write_sao_ctb_params(sao_ctb, bd)))
    for pid, name in enumerate(("Y", "U", "V")):
        lev, n = levels[name]
        lev = np.ascontiguousarray(lev, np.int32)
        nb = lev.shape[0]
        grid = mode_grid(nb, width, height, n, pid)
        if grid is None:
            raise ValueError(f"{nb} blocks do not tile plane {name}")
        mpay = encode_modes(modes[name], *grid)
        sel = (mode_scan_idx(modes[name], n) if scan == "mode"
               else np.full(nb, SCAN_IDX[scan], np.int64))
        inv = np.argsort(_scan_orders(n), axis=1)
        raster = np.take_along_axis(lev, inv[sel], axis=1).reshape(nb, n, n)
        payload = encode_plane_cabac(raster, sel, 0 if name == "Y" else 1, qp)
        header = struct.pack("<HHIIII", pid, n, qp, nb, len(mpay),
                             len(payload))
        out.append(wrap_nal(NAL_SLICE, header + mpay + payload))
    return b"".join(out)
