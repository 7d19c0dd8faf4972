"""The loop filters' CUDA kernels, held on the CPU through numpy models
of their schedules and arithmetic, and their wrappers against JAX.

`csrc/deblock.cu` and `csrc/sao.cu` run only on a card (chip_smoke's
phase 3i holds them to their plain versions there).  Here:

- a numpy model of the fused deblocking schedule (thread-block tiles of
  the kernel's size, read from its source, copied with a 4-sample halo;
  the vertical pass's (row, octet) items warp by warp over the tile's
  rows and halo rows, a luma segment decided from lines 0 and 3 of its
  quad as the lanes exchange them; then the horizontal pass's (octet of
  rows, column) items on its output) equals `ops.deblock_plane` and
  JAX's `deblock_plane`, on shapes with tails, shapes narrower than a
  tile and a batch with a (B,) QP; the shared pitch keeps a quarter
  warp's 16-byte accesses on distinct banks;
- a numpy model of the estimate kernel's decision epilogue (the lanes
  of a warp, their float32 ops one rounding each, the class sums and
  band windows gathered lane by lane, the lane-local and butterfly first
  minimum; CTB SAO's thread blocks as generators over groups of tiles,
  taking tickets, publishing pass 1 as tagged words and polling their
  neighbours' under several schedules; per-plane SAO's uint32 sums in a
  shuffled tile order, decided by the plane's last tile), two launches
  back to back on one workspace, equals `estimate_sao_ctb` and
  `estimate_sao` (the port's and JAX's), ties included, and leaves the
  workspace at rest; a schedule that reads words without their tag
  does not;
- the wrappers on CPU tensors equal JAX's functions, a `meta` tensor
  raises, the CPU route never loads CUDA code, and the closed loop's
  encoder and decoder reach the filters through the wrappers.

The tolerance is 0 throughout.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu.ops import deblock_plane as jax_deblock
from nanohevc_tpu.ops import sao as j_sao
from nanohevc_tpu.ops import sao_ctb as j_ctb
from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels import loop_filter as lf
from nanohevc_tpu_torch.models import wavefront as twf
from nanohevc_tpu_torch.ops import sao as t_sao
from nanohevc_tpu_torch.ops import sao_ctb as t_ctb
from nanohevc_tpu_torch.ref import deblock as ref_deblock
from nanohevc_tpu_torch.ref import sao as ref_sao

from test_torch_deblock import blocky
from test_torch_sao import SHAPES, pair

CSRC = Path(__file__).resolve().parent.parent / "nanohevc_tpu_torch" / "csrc"
F = np.float32


def cu_int(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def cu_table(source: str, name: str) -> list:
    body = re.search(rf"{name}\[[\d\]\[]*\] = \{{(.*?)\}};", source,
                     re.S).group(1)
    return [int(v) for v in re.findall(r"-?\d+", body)]


DEBLOCK_CU = (CSRC / "deblock.cu").read_text()
SAO_CU = (CSRC / "sao.cu").read_text()
TILE_H, TILE_W = cu_int(DEBLOCK_CU, "kTileH"), cu_int(DEBLOCK_CU, "kTileW")
HALO, THREADS = cu_int(DEBLOCK_CU, "kHalo"), cu_int(DEBLOCK_CU, "kThreads")
PITCH = TILE_W + 2 * HALO + int(re.search(
    r"constexpr int kPitch = kCols \+ (\d+);", DEBLOCK_CU).group(1))
BETA, TC = cu_table(DEBLOCK_CU, "kBeta"), cu_table(DEBLOCK_CU, "kTc")
COUNTERS = cu_int(SAO_CU, "kCounters")
WORD_OFF, WORD_OFF_BITS = (cu_int(SAO_CU, "kWordOff"),
                           cu_int(SAO_CU, "kWordOffBits"))


def test_kernel_tables_are_the_spec_tables():
    assert BETA == ref_deblock.BETA_TABLE.tolist()
    assert TC == ref_deblock.TC_TABLE.tolist()
    neighbors = cu_table(SAO_CU, "kNeighbors")
    assert neighbors == [v for row in ref_sao.EO_NEIGHBORS for v in row]
    assert cu_int(SAO_CU, "kStatInts") == lf.STAT_INTS
    assert COUNTERS == lf.COUNTER_INTS
    # segments stay aligned, warps run whole, quads are segments
    assert TILE_H % 8 == 0 and TILE_W % 8 == 0 and HALO == 4
    assert THREADS % 32 == 0
    # the 8 lanes of a quarter warp of the vertical pass (8 rows of an
    # octet) meet 8 distinct 16-byte slots of the banks in both loads
    for first in range(0, len(vertical_items(TILE_H, TILE_W)), 8):
        lanes = vertical_items(TILE_H, TILE_W)[first:first + 8]
        for half in (0, 4):
            slots = {(r * PITCH + 8 * j + half) // 4 % 8 for r, j in lanes}
            assert len(slots) == len(lanes)
    # every offset fits its field of a published word
    assert WORD_OFF + 4 * WORD_OFF_BITS == 32
    assert max(map(ref_sao.max_offset, range(5, 17))) < 1 << (
        WORD_OFF_BITS - 1)


# --- the fused deblocking schedule ------------------------------------------

def ctrunc(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    return abs(a) // b * (1 if a >= 0 else -1)


def clamp3(v, lo, hi):
    return min(max(v, lo), hi)


def vertical_items(tile_h, tile_w):
    """(shared row, octet) of each vertical-pass item, in deblock.cu's
    order: item i is row 8 * (i // 8 // octets) + i % 8 of octet
    i // 8 % octets."""
    octets = tile_w // 8 + 1
    return [(8 * ((i >> 3) // octets) + (i & 7), (i >> 3) % octets)
            for i in range((tile_h + 2 * HALO) * octets)]


def horizontal_items(tile_h, tile_w):
    """(octet of rows, tile column) of each horizontal-pass item."""
    return [(i // tile_w, i % tile_w)
            for i in range((tile_h // 8 + 1) * tile_w)]


def luma_terms(v, beta, tc):
    """A lane's own line of [p3 p2 p1 p0 q0 q1 q2 q3]: d_p, and 2 d_q
    plus its strong test (the words the quad exchanges)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = v
    dp, dq = abs(p2 - 2 * p1 + p0), abs(q2 - 2 * q1 + q0)
    tc5 = (5 * tc + 1) >> 1
    strong = (2 * (dp + dq) < (beta >> 2)
              and abs(p3 - p0) + abs(q0 - q3) < (beta >> 3)
              and abs(p0 - q0) < tc5)
    return dp, 2 * dq + int(strong)


def filter_luma_line(v, on, lead, last, beta, tc, pix_max):
    """deblock.cu's filter_luma_line on v (changed in place) with the
    terms of its quad's lanes 0 (`lead`) and 3 (`last`); returns whether
    v changed."""
    (dp0, dqs0), (dp3, dqs3) = lead, last
    dp03, dq03 = dp0 + dp3, (dqs0 >> 1) + (dqs3 >> 1)
    if not (on and dp03 + dq03 < beta):
        return False
    p3, p2, p1, p0, q0, q1, q2, q3 = v
    c2 = 2 * tc
    if dqs0 & dqs3 & 1:
        v[1:7] = [
            clamp3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - c2,
                   p2 + c2),
            clamp3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2),
            clamp3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - c2,
                   p0 + c2),
            clamp3((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - c2,
                   q0 + c2),
            clamp3((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2, q1 + c2),
            clamp3((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - c2,
                   q2 + c2)]
        return True
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    if not abs(delta) < 10 * tc:
        return False
    side, th = (beta + (beta >> 1)) >> 3, tc >> 1
    dc = clamp3(delta, -tc, tc)
    v[3], v[4] = clamp3(p0 + dc, 0, pix_max), clamp3(q0 - dc, 0, pix_max)
    if dp03 < side:
        v[2] = clamp3(p1 + clamp3((((p2 + p0 + 1) >> 1) - p1 + dc) >> 1,
                                  -th, th), 0, pix_max)
    if dq03 < side:
        v[5] = clamp3(q1 + clamp3((((q2 + q0 + 1) >> 1) - q1 - dc) >> 1,
                                  -th, th), 0, pix_max)
    return True


def filter_chroma_line(v, tc, pix_max):
    p1, p0, q0, q1 = v[2:6]
    delta = clamp3(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, -tc, tc)
    v[3], v[4] = clamp3(p0 + delta, 0, pix_max), clamp3(q0 - delta, 0,
                                                        pix_max)


def warp_pass(lines, ons, is_chroma, beta, tc, pix_max):
    """One warp's lanes of a pass: each lane's octet `lines[lane]`
    (read by every lane before any writes), filtered where `ons[lane]`;
    a luma lane reads its quad's lines 0 and 3 as __shfl_sync does.
    Returns which lanes changed their octet."""
    if is_chroma:
        for v, on in zip(lines, ons):
            if on:
                filter_chroma_line(v, tc, pix_max)
        return list(ons)
    terms = [luma_terms(v, beta, tc) for v in lines]
    return [filter_luma_line(v, on, terms[lane & ~3], terms[(lane & ~3) + 3],
                             beta, tc, pix_max)
            for lane, (v, on) in enumerate(zip(lines, ons))]


def fused_deblock_model(planes, qps, bit_depth, is_chroma, tile_h=TILE_H,
                        tile_w=TILE_W, halo_rows=True):
    """deblock.cu's schedule: per thread block a tile_h x tile_w tile
    with a HALO-sample halo in 'shared memory' (0 off the plane); the
    vertical pass's (row, octet) items warp by warp (on the halo rows
    too unless `halo_rows` is False), each octet read, filtered with its
    quad and written back; then the horizontal pass's (octet of rows,
    column) items on its output, the tile's rows among each octet
    written to the output."""
    b, h, w = planes.shape
    out = np.empty_like(planes)
    pix_max = (1 << bit_depth) - 1
    v_items, h_items = (vertical_items(tile_h, tile_w),
                        horizontal_items(tile_h, tile_w))
    for plane in range(b):
        qp = int(qps[plane])
        beta = BETA[clamp3(qp, 0, 51)] << (bit_depth - 8)
        tc = TC[clamp3(qp + 2, 0, 53)] << (bit_depth - 8)
        for y0 in range(0, h, tile_h):
            for x0 in range(0, w, tile_w):
                s = np.zeros((tile_h + 2 * HALO, tile_w + 2 * HALO), np.int64)
                ys = slice(max(y0 - HALO, 0), min(y0 + tile_h + HALO, h))
                xs = slice(max(x0 - HALO, 0), min(x0 + tile_w + HALO, w))
                s[ys.start - y0 + HALO:ys.stop - y0 + HALO,
                  xs.start - x0 + HALO:xs.stop - x0 + HALO] = \
                    planes[plane, ys, xs]
                for first in range(0, len(v_items), 32):
                    lanes = v_items[first:first + 32]
                    lines = [[int(x) for x in s[r, 8 * j:8 * j + 8]]
                             for r, j in lanes]
                    ons = []
                    for r, j in lanes:
                        kx, gy = x0 // 8 + j, y0 - HALO + r
                        on = 1 <= kx <= ctrunc(w - 4, 8) and (
                            halo_rows or HALO <= r < HALO + tile_h)
                        if is_chroma:
                            on = on and 0 <= gy < h
                        else:
                            seg = gy - (r & 3)
                            on = on and seg >= 0 and seg // 4 < h // 4
                        ons.append(on)
                    changed = warp_pass(lines, ons, is_chroma, beta, tc,
                                        pix_max)
                    for (r, j), v, ch in zip(lanes, lines, changed):
                        if ch:
                            s[r, 8 * j:8 * j + 8] = v
                for first in range(0, len(h_items), 32):
                    lanes = h_items[first:first + 32]
                    lines = [[int(x) for x in s[8 * k:8 * k + 8, HALO + c]]
                             for k, c in lanes]
                    ons = []
                    for k, c in lanes:
                        ky, gx = y0 // 8 + k, x0 + c
                        on = 1 <= ky <= ctrunc(h - 4, 8)
                        ons.append(on and (gx < w if is_chroma
                                           else gx // 4 < w // 4))
                    warp_pass(lines, ons, is_chroma, beta, tc, pix_max)
                    for (k, c), v in zip(lanes, lines):
                        for t in range(8):
                            row = 8 * k + t - HALO
                            if (0 <= row < tile_h and y0 + row < h
                                    and x0 + c < w):
                                out[plane, y0 + row, x0 + c] = v[t]
    return out


# (shape, bit depth): a tile's tails in both directions (two tile rows,
# three tile columns, neither a multiple of 8), a height that is no
# multiple of 4, shapes narrower than a tile (one 8-column edge, none)
DEBLOCK_CASES = [((70, 134), 8), ((38, 50), 10), ((22, 64), 8), ((8, 13), 8)]


@pytest.mark.parametrize("is_chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("shape,bit_depth", DEBLOCK_CASES,
                         ids=[f"{h}x{w}-{bd}bit" for (h, w), bd in DEBLOCK_CASES])
def test_fused_deblock_schedule(shape, bit_depth, is_chroma):
    plane = blocky(*shape, bit_depth, sum(shape) + is_chroma)
    got = fused_deblock_model(plane[None], [37], bit_depth, is_chroma)[0]
    want = ops.deblock_plane(torch.from_numpy(plane), 37, bit_depth,
                             is_chroma).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jax_deblock(
        jnp.asarray(plane), 37, bit_depth, is_chroma)))
    if min(shape) >= 16:
        assert not np.array_equal(got, plane)      # the filter acted


@pytest.mark.parametrize("is_chroma", [False, True], ids=["luma", "chroma"])
def test_fused_deblock_schedule_batch_with_two_qps(is_chroma):
    planes = np.stack([blocky(40, 72, 8, 11), blocky(40, 72, 8, 12)])
    qps = [22, 45]
    got = fused_deblock_model(planes, qps, 8, is_chroma)
    assert np.array_equal(got, ops.deblock_plane(
        torch.from_numpy(planes), torch.tensor(qps), 8, is_chroma).numpy())
    for plane, g, qp in zip(planes, got, qps):
        assert np.array_equal(g, np.asarray(jax_deblock(
            jnp.asarray(plane), qp, 8, is_chroma)))


@pytest.mark.parametrize("is_chroma", [False, True], ids=["luma", "chroma"])
def test_fused_deblock_schedule_needs_its_halo_rows(is_chroma):
    """Tiles of 8x8 samples, every edge a seam between thread blocks,
    give the same pixels; a schedule that leaves the halo rows out of
    the vertical pass does not (the horizontal pass reads 4 filtered
    rows above and below the tile)."""
    plane = blocky(40, 64, 8, 3)[None]
    want = ops.deblock_plane(torch.from_numpy(plane), 45, 8,
                             is_chroma).numpy()
    assert np.array_equal(fused_deblock_model(plane, [45], 8, is_chroma,
                                              tile_h=8, tile_w=8), want)
    assert not np.array_equal(fused_deblock_model(
        plane, [45], 8, is_chroma, halo_rows=False), want)


# --- the decision kernel's lanes ----------------------------------------------

def offset_of(cnt, ssum, lo, hi):
    if cnt <= 0:
        return 0
    o = np.rint(F(ssum) / F(cnt))
    return clamp3(int(o), lo, hi)


def delta_sse(cnt, ssum, o):
    fc, fs, fo = F(cnt), F(ssum), F(o)
    return F(F(fc * F(fo * fo)) - F(F(F(2.0) * fo) * fs))


def lanes_decide(st, cap, prices):
    """sao.cu's decide() over the 32 lanes of a warp: (cost, type, band,
    offsets) of one tile's 96 statistics; prices (off, eo, bo) or None."""
    lane = range(32)
    ec = [int(st[i]) if i < 16 else 0 for i in lane]
    es = [int(st[16 + i]) if i < 16 else 0 for i in lane]
    bc = [int(st[32 + i]) for i in lane]
    bs = [int(st[64 + i]) for i in lane]
    eo = [offset_of(ec[i], es[i], 0 if i % 4 < 2 else -cap,
                    cap if i % 4 < 2 else 0) for i in lane]
    ed = [delta_sse(ec[i], es[i], eo[i]) for i in lane]
    bo = [offset_of(bc[i], bs[i], -cap, cap) for i in lane]
    bd = [delta_sse(bc[i], bs[i], bo[i]) for i in lane]
    d_eo, d_win = [], []
    for i in lane:
        k = i & 3
        e, wv = ed[4 * k], bd[i]
        for j in range(1, 4):
            e = F(e + ed[4 * k + j])
            wv = F(wv + bd[(i + j) & 31])
        d_eo.append(e)
        d_win.append(wv)
    best, idx = [F(np.inf)] * 32, [64] * 32
    for i in lane:
        cands = []
        if i == 0:
            cands.append((F(prices[0]) if prices else F(0.0), 0))
        if i < 4:
            cands.append((F(d_eo[i] + F(prices[1])) if prices else d_eo[i],
                          1 + i))
        if i < 29:
            cands.append((F(d_win[i] + F(prices[2])) if prices else d_win[i],
                          5 + i))
        for sc, ci in cands:
            if sc < best[i]:
                best[i], idx[i] = sc, ci
    m = 16
    while m:
        nb, ni = list(best), list(idx)
        for i in lane:
            ob, oi = best[i ^ m], idx[i ^ m]
            if ob < best[i] or (ob == best[i] and oi < idx[i]):
                nb[i], ni[i] = ob, oi
        best, idx, m = nb, ni, m // 2
    assert len(set(idx)) == 1
    i = idx[0]
    if i == 0:
        return best[0], 0, 0, [0, 0, 0, 0]
    if i <= 4:
        return best[0], i, 0, [eo[4 * (i - 1) + j] for j in range(4)]
    return best[0], 5, i - 5, [bo[i - 5 + j] for j in range(4)]


def lanes_params_delta(st, typ, band, off):
    d = F(0.0)
    for j in range(4):
        if 1 <= typ <= 4:
            b = 4 * (typ - 1) + j
            d = F(d + delta_sse(st[b], st[16 + b], off[j]))
        elif typ == 5:
            b = (band + j) & 31
            d = F(d + delta_sse(st[32 + b], st[64 + b], off[j]))
    return d


def pack_word(choice, tag):
    """sao.cu's published word: type, band and the four 6-bit offsets in
    the low 32 bits (pack_params), the tag in the high 32."""
    _, typ, band, off = choice
    w = typ | band << 3
    for j, o in enumerate(off):
        w |= (o & ((1 << WORD_OFF_BITS) - 1)) << (WORD_OFF + WORD_OFF_BITS * j)
    return tag << 32 | w


def unpack_word(word):
    """(type, band, offsets) of a word, as wait_params reads them."""
    p, half = word & 0xffffffff, 1 << (WORD_OFF_BITS - 1)
    off = [((p >> (WORD_OFF + WORD_OFF_BITS * j)) + half) %
           (1 << WORD_OFF_BITS) - half for j in range(4)]
    return p & 7, (p >> 3) & 31, off


class Workspace:
    """nhv_sao_estimate's workspace as the wrapper allocates it (zeros):
    the ticket's count and generation, per-plane done counts and uint32
    sums, a word a tile."""

    def __init__(self, planes=8):
        self.ticket = self.generation = 0
        self.done = [0] * planes
        self.sums = np.zeros((planes, lf.STAT_INTS), np.uint32)
        self.words = {}

    def at_rest(self):
        return self.ticket == 0 and not any(self.done) and not self.sums.any()


def ctb_group(ws, block, groups, per_group, stats, cap, prices, merge, out,
              check_tag):
    """One thread block of the estimate kernel under CTB SAO: its group
    is its ticket under merge (the block taking the last one zeroes the
    count and moves the generation on; the tag is the generation + 1),
    else its blockIdx `block`.  For each tile of the group in order,
    after its statistics (a `yield`): the tile's pass 1, stored, or under
    merge published as its word (a `yield`).  Then, under merge, for each
    tile in order: its left and upper neighbours' words polled (a
    `yield` a failed poll), the merge pass, the maps stored."""
    b, nty, ntx, _ = stats.shape
    g, tag = block, 0
    if merge:
        g, tag = ws.ticket, (ws.generation + 1) & 0xffffffff
        ws.ticket += 1
        if g == groups - 1:
            ws.ticket = 0
            ws.generation += 1
    tiles = range(g * per_group, min(g * per_group + per_group,
                                     b * nty * ntx))
    pass1 = {}

    def where(t):
        plane, cell = divmod(t, nty * ntx)
        return (plane,) + divmod(cell, ntx)

    for t in tiles:
        yield "statistics"
        pass1[t] = lanes_decide(stats[where(t)], cap, prices)
        if merge:
            ws.words[t] = pack_word(pass1[t], tag)
            yield "published"
        else:
            for m, v in zip(out, pass1[t][1:]):
                m[where(t)] = v
    if not merge:
        return
    for t in tiles:
        plane, ty, tx = where(t)
        own, best = stats[plane, ty, tx], pass1[t]
        nbrs = [n for has, n in ((tx > 0, t - 1), (ty > 0, t - ntx)) if has]
        while check_tag and any(ws.words.get(n, 0) >> 32 != tag
                                for n in nbrs):
            yield "poll"
        for nbr in nbrs:                                   # left, then up
            nt, nb, no = unpack_word(ws.words.get(nbr, 0))
            d = F(0.0) if nt == 0 else lanes_params_delta(own, nt, nb, no)
            cost = F(d + F(prices[3]))
            if cost < best[0]:
                best = (cost, nt, nb, no)
        for m, v in zip(out, best[1:]):
            m[plane, ty, tx] = v


# Schedules of the CTB blocks: (blocks resident at once, tiles a group).
SCHEDULES = {"random": (3, 3), "one resident": (1, 1),
             "newest first": (None, 2)}


def estimate_model(stats, bit_depth, prices=None, merge=True, ws=None,
                   rng=None, schedule="random", check_tag=True):
    """sao.cu's estimate kernel from (B, nty, ntx, 96) statistics (its
    counting is held to `sao_statistics_reference` on the card): the
    decisions of every thread block under a schedule.

    Per-plane SAO (prices None): the tiles in a shuffled order add their
    statistics to the plane's uint32 sums and count themselves done; the
    plane's last tile reads and zeroes the sums and decides.  CTB SAO:
    `ctb_group` generators over groups of `SCHEDULES[schedule][1]`
    tiles, started in a shuffled blockIdx order and run as the schedule
    says: "random" (up to 3 resident blocks, a random one steps), "one
    resident" (a block runs to its end before the next starts), "newest
    first" (every block started, the newest that is not polling steps,
    else the oldest)."""
    rng = rng or np.random.default_rng(0)
    ws = ws or Workspace(stats.shape[0])
    cap = ref_sao.max_offset(bit_depth)
    b, nty, ntx, _ = stats.shape
    if prices is None:
        out = (np.zeros(b, np.int32), np.zeros(b, np.int32),
               np.zeros((b, 4), np.int32))
        for t in rng.permutation(b * nty * ntx):
            plane, cell = divmod(int(t), nty * ntx)
            ty, tx = divmod(cell, ntx)
            ws.sums[plane] += stats[plane, ty, tx].astype(np.uint32)
            ws.done[plane] += 1
            if ws.done[plane] == nty * ntx:
                total = ws.sums[plane].view(np.int32).astype(np.int64)
                ws.sums[plane] = 0
                ws.done[plane] = 0
                _, typ, band, off = lanes_decide(total, cap, None)
                out[0][plane], out[1][plane], out[2][plane] = typ, band, off
        return out
    out = (np.zeros((b, nty, ntx), np.int32), np.zeros((b, nty, ntx), np.int32),
           np.zeros((b, nty, ntx, 4), np.int32))
    resident, per_group = SCHEDULES[schedule]
    groups = -(-b * nty * ntx // per_group)
    waiting = groups
    blocks = iter(rng.permutation(groups).tolist())
    active, said = [], []                 # generators, their last yield
    steps = 0
    while waiting or active:
        steps += 1
        assert steps < 100 * b * nty * ntx + 100, "the schedule deadlocked"
        start = waiting and len(active) < (resident or groups) and (
            schedule != "random" or not active or rng.random() < 0.5)
        if start:
            waiting -= 1
            active.append(ctb_group(ws, next(blocks), groups, per_group,
                                    stats, cap, prices, merge, out,
                                    check_tag))
            said.append(None)
            pick = len(active) - 1
        elif schedule == "random":
            pick = int(rng.integers(len(active)))
        else:                 # the newest that is not polling, else the oldest
            free = [i for i, y in enumerate(said) if y != "poll"]
            pick = free[-1] if free else 0
        try:
            said[pick] = next(active[pick])
        except StopIteration:
            active.pop(pick)
            said.pop(pick)
            continue
        if said[pick] == "published":     # a word to read: poll again
            said = [None if y == "poll" else y for y in said]
    return out


def same(got, want):
    for g, w in zip(got, want, strict=True):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no-merge"])
@pytest.mark.parametrize("h,w,tile", SHAPES + [(40, 300, 16), (100, 30, 32)])
def test_decision_lanes_equal_estimate_sao_ctb(h, w, tile, merge, schedule):
    """The estimate kernel's epilogue under each schedule, two launches
    back to back on one workspace with no reset between them (the second
    on other planes), == `estimate_sao_ctb` (the port's and JAX's); the
    workspace is left at rest.  (40, 300) at tile 16 has 19 tile
    columns, (100, 30) at tile 32 one."""
    ws = Workspace()
    rng = np.random.default_rng(h * w + tile)
    for seed in (h + w, h + w + 1):
        src, rec = pair(h, w, 8, seed)
        stats = lf.sao_statistics_reference(torch.from_numpy(src)[None],
                                            torch.from_numpy(rec)[None], tile)
        got = estimate_model(stats.numpy(), 8, lf.sao_prices(27, 0.5), merge,
                             ws, rng, schedule)
        same(got, t_ctb.estimate_sao_ctb(torch.from_numpy(src)[None],
                                         torch.from_numpy(rec)[None], tile,
                                         27, 8, 0.5, merge))
        same([g[0] for g in got], j_ctb.estimate_sao_ctb(
            jnp.asarray(src), jnp.asarray(rec), tile, 27, 8, 0.5, merge))
        assert ws.at_rest()
    assert ws.generation == (2 if merge else 0)


def test_estimate_schedule_needs_its_tags():
    """A block that read its neighbours' words without their tag would,
    on the second of two launches, take pass-1 parameters left by the
    first where it runs ahead of its neighbours (the newest block first:
    every merge is priced on a stale word); the tagged words give the
    plain result under the same schedule."""
    pairs = [pair(128, 256, 8, 107), pair(128, 256, 8, 7)]
    stats = [lf.sao_statistics_reference(torch.from_numpy(a)[None],
                                         torch.from_numpy(b)[None], 16).numpy()
             for a, b in pairs]
    src, rec = (torch.from_numpy(x)[None] for x in pairs[1])
    want = t_ctb.estimate_sao_ctb(src, rec, 16, 22)
    assert not all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(
        want, t_ctb.estimate_sao_ctb(src, rec, 16, 22, merge=False)))
    for check_tag in (True, False):
        ws = Workspace()
        for st in stats:
            got = estimate_model(st, 8, lf.sao_prices(22), True, ws,
                                 schedule="newest first", check_tag=check_tag)
        agree = all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
        assert agree == check_tag


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_decision_lanes_equal_estimate_sao(bit_depth):
    """Per-plane SAO: three planes, the blocks in a shuffled order, two
    launches back to back on one workspace."""
    pairs = [pair(48, 64, bit_depth, s) for s in range(3)]
    src = np.stack([p[0] for p in pairs])
    rec = np.stack([p[1] for p in pairs])
    stats = lf.sao_statistics_reference(torch.from_numpy(src),
                                        torch.from_numpy(rec),
                                        lf.FRAME_STATS_TILE, bit_depth)
    ws = Workspace()
    for seed in (1, 2):
        got = estimate_model(stats.numpy(), bit_depth, ws=ws,
                             rng=np.random.default_rng(seed))
        same(got, t_sao.estimate_sao(torch.from_numpy(src),
                                     torch.from_numpy(rec), bit_depth))
        assert ws.at_rest()
    for i in range(len(pairs)):
        same([g[i] for g in got], j_sao.estimate_sao(
            jnp.asarray(src[i]), jnp.asarray(rec[i]), bit_depth))


def test_decision_lanes_per_plane_sums_wrap():
    """Per-plane sums past int32 wrap as the plain version's do, in any
    order of the blocks."""
    stats = np.zeros((1, 2, 3, lf.STAT_INTS), np.int32)
    stats[..., 32 + 7] = 400_000_000                   # band 7's count
    stats[..., 64 + 7] = 2_000_000_000                 # and sum
    stats[..., 0] = 1000
    stats[..., 16] = -900_000
    want = lf.sao_decide_reference(torch.from_numpy(stats), bit_depth=10)
    for seed in range(3):
        same(estimate_model(stats, 10, rng=np.random.default_rng(seed)), want)


def test_decision_lanes_take_the_first_of_equal_scores():
    """Forced ties: a flat reconstruction one level below the source puts
    every sample in band 12 with offset 1, so the four band windows that
    hold band 12 score the same (positions 9-12; the first wins), and the
    EO classes all score 0 beside the off candidate (0 wins over them);
    with no difference at all and no price all 34 candidates tie at 0.
    Crafted statistics tie EO classes 1 and 3 below every window."""
    src = np.full((40, 72), 101, np.int32)
    rec = np.full((40, 72), 100, np.int32)
    s, r = torch.from_numpy(src)[None], torch.from_numpy(rec)[None]
    st = lf.sao_statistics_reference(s, r, lf.FRAME_STATS_TILE).numpy()
    got = estimate_model(st, 8)
    assert (got[0][0], got[1][0]) == (ref_sao.SAO_BO, 9)
    same(got, t_sao.estimate_sao(s, r))
    same([g[0] for g in got], j_sao.estimate_sao(jnp.asarray(src),
                                                 jnp.asarray(rec)))
    for tie_src, scale in ((src, 1.0), (rec, 0.0)):
        ts = torch.from_numpy(tie_src)[None]
        st = lf.sao_statistics_reference(ts, r, 16).numpy()
        got = estimate_model(st, 8, lf.sao_prices(22, scale))
        same(got, t_ctb.estimate_sao_ctb(ts, r, 16, 22, 8, scale))
        same([g[0] for g in got], j_ctb.estimate_sao_ctb(
            jnp.asarray(tie_src), jnp.asarray(rec), 16, 22, 8, scale))
    assert (got[0] == ref_sao.SAO_OFF).all()
    crafted = np.zeros((2, 1, 3, lf.STAT_INTS), np.int32)
    for cls in (1, 3):
        crafted[..., 4 * cls:4 * cls + 4] = 50          # counts
        crafted[..., 16 + 4 * cls:16 + 4 * cls + 2] = 150
        crafted[..., 16 + 4 * cls + 2:16 + 4 * cls + 4] = -150
    crafted[1, ..., 32:64] = 3                          # flat band counts
    crafted[1, ..., 64:96] = 3
    for prices in (None, lf.sao_prices(22, 0.0)):
        got = estimate_model(crafted, 8, prices)
        assert (np.asarray(got[0]) == ref_sao.SAO_EO0 + 1).all()
        same(got, lf.sao_decide_reference(torch.from_numpy(crafted),
                                          prices=prices))


def test_published_words_round_trip():
    """Every type, band position and offset in [-31, 31] survives the
    word, whatever the tag."""
    offs = np.arange(-31, 32)
    for typ in range(6):
        for band in range(29):
            off = [int(x) for x in np.roll(offs, typ + band)[:4]]
            for tag in (1, 0xffffffff):
                word = pack_word((None, typ, band, off), tag)
                assert word >> 32 == tag
                assert unpack_word(word) == (typ, band, off)


def test_statistics_layout_is_jaxs_tile_stats():
    src, rec = pair(72, 100, 10, 4)
    got = lf.sao_statistics_reference(torch.from_numpy(src),
                                      torch.from_numpy(rec), 32, 10).numpy()
    want = j_ctb.sao_tile_stats(jnp.asarray(src), jnp.asarray(rec), 32, 10)
    at = 0
    for key, n in lf.STAT_LAYOUT:
        w = np.asarray(want[key]).reshape((n,) + got.shape[:2])
        assert np.array_equal(np.moveaxis(got[..., at:at + n], -1, 0), w), key
        at += n


# --- the wrappers -------------------------------------------------------------

def test_wrappers_on_cpu_equal_jax():
    planes = np.stack([blocky(40, 72, 8, 21), blocky(40, 72, 8, 22)])
    t = torch.from_numpy(planes)
    for qp in (30, torch.tensor([22, 45])):
        got = lf.deblock_planes(t, qp, 8, False).numpy()
        for i, plane in enumerate(planes):
            q = qp if isinstance(qp, int) else int(qp[i])
            assert np.array_equal(got[i], np.asarray(jax_deblock(
                jnp.asarray(plane), q, 8, False)))
    src, rec = pair(72, 100, 8, 9)
    s, r = torch.from_numpy(src), torch.from_numpy(rec)
    params = lf.sao_estimate(s, r)
    same(params, j_sao.estimate_sao(jnp.asarray(src), jnp.asarray(rec)))
    same([lf.sao_apply(r, *params)], [j_sao.apply_sao(
        jnp.asarray(rec), *(np.asarray(p) for p in params))])
    maps = lf.sao_estimate(s, r, tile=32, qp=22, merge=True)
    same(maps, j_ctb.estimate_sao_ctb(jnp.asarray(src), jnp.asarray(rec), 32,
                                      22))
    same([lf.sao_apply(r, *maps, 32)], [j_ctb.apply_sao_ctb(
        jnp.asarray(rec), *(jnp.asarray(m.numpy()) for m in maps), 32)])
    again, stats = lf.sao_estimate(s, r, tile=32, qp=22, return_stats=True)
    same(again, maps)
    tile_stats = j_ctb.sao_tile_stats(jnp.asarray(src), jnp.asarray(rec), 32)
    assert np.array_equal(stats[..., 32:64].permute(2, 0, 1).numpy(),
                          np.asarray(tile_stats["bo_cnt"]))


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 16, 16), dtype=torch.int32, device="meta")
    calls = [lambda: lf.deblock_planes(meta, 22),
             lambda: lf.sao_estimate(meta, meta, return_stats=True),
             lambda: lf.sao_estimate(meta, meta, tile=16, qp=22,
                                     return_stats=True),
             lambda: lf.sao_estimate(meta, meta),
             lambda: lf.sao_estimate(meta, meta, tile=16, qp=22),
             lambda: lf.sao_apply(meta, 0, 0, [0] * 4)]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_closed_loop_reaches_the_filters_through_the_wrappers(monkeypatch):
    """The encoder's filter block and decode_planes call the wrappers
    (here on the CPU: their plain versions, with no CUDA code loaded)."""
    def refuse(name):
        raise AssertionError("the CPU route loaded a CUDA library")

    monkeypatch.setattr(lf, "cuda_kernels", refuse)
    seen = []
    for name in ("deblock_planes", "sao_estimate", "sao_apply"):
        def counted(*a, _fn=getattr(lf, name), _name=name, **kw):
            seen.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(twf, name, counted)
    plane = torch.from_numpy(blocky(24, 40, 8, 5))
    for kw in (dict(sao=True), dict(sao_ctb=True, sao_tile=16)):
        seen.clear()
        out = twf.encode_plane_closed_loop(plane, 30, n=8, deblock=True, **kw)
        assert seen == ["deblock_planes", "sao_estimate", "sao_apply"]
        seen.clear()
        sao = {"sao": out["sao"]} if "sao" in out else {
            "sao_ctb": (16,) + tuple(out["sao_ctb"])}
        dec = twf.decode_plane(out["levels"], out["modes"], 30, n=8,
                               height=24, width=40, deblock=True, **sao)
        assert seen == ["deblock_planes", "sao_apply"]
        assert torch.equal(dec, out["recon"])
