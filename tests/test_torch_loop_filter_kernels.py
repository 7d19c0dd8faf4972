"""The loop filters' CUDA kernels, held on the CPU through numpy models
of their schedules and arithmetic, and their wrappers against JAX.

`csrc/deblock.cu` and `csrc/sao.cu` run only on a card (chip_smoke's
phase 3i holds them to their plain versions there).  Here:

- a numpy model of the fused deblocking schedule (thread-block tiles of
  the kernel's size, read from its source, loaded with a 4-sample halo,
  the vertical pass over the tile's rows and halo rows item by item,
  then the horizontal pass on its output) equals `ops.deblock_plane` and
  JAX's `deblock_plane`, on shapes with tails, shapes narrower than a
  tile and a batch with a (B,) QP;
- a numpy model of the decision kernel's lanes (a lane a band and an EO
  bin, its float32 ops one rounding each, the class sums and band
  windows gathered lane by lane, the lane-local and butterfly first
  minimum, the merge pass on pass-1 choices recomputed for the tiles
  above and to the left of a thread block) equals `estimate_sao_ctb` and
  `estimate_sao` (the port's and JAX's), ties included;
- the three wrappers on CPU tensors equal JAX's functions, a `meta`
  tensor raises, the CPU route never loads CUDA code, and the closed
  loop's encoder and decoder reach the filters through the wrappers.

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
BETA, TC = cu_table(DEBLOCK_CU, "kBeta"), cu_table(DEBLOCK_CU, "kTc")
DECIDE_WARPS = cu_int(SAO_CU, "kDecideWarps")


def test_kernel_tables_are_the_spec_tables():
    assert BETA == ref_deblock.BETA_TABLE.tolist()
    assert TC == ref_deblock.TC_TABLE.tolist()
    neighbors = cu_table(SAO_CU, "kNeighbors")
    assert neighbors == [v for row in ref_sao.EO_NEIGHBORS for v in row]
    assert cu_int(SAO_CU, "kStatInts") == lf.STAT_INTS
    # both passes' items fit the thread block once (the kernel's asserts)
    assert (TILE_W // 8 + 1) * ((TILE_H + 2 * HALO) // 4) <= THREADS
    assert (TILE_H // 8 + 1) * (TILE_W // 4) <= THREADS
    assert TILE_H % 8 == 0 and TILE_W % 8 == 0 and HALO == 4


# --- the fused deblocking schedule ------------------------------------------

def ctrunc(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    return abs(a) // b * (1 if a >= 0 else -1)


def clamp3(v, lo, hi):
    return min(max(v, lo), hi)


def filter_luma(s, r0, c, beta, tc, pix_max):
    """deblock.cu's filter_luma on lines r0..r0+3 of s, q0 at column c."""
    p = [[int(s[r0 + lr, c - 1 - i]) for i in range(4)] for lr in range(4)]
    q = [[int(s[r0 + lr, c + i]) for i in range(4)] for lr in range(4)]
    dp0 = abs(p[0][2] - 2 * p[0][1] + p[0][0])
    dq0 = abs(q[0][2] - 2 * q[0][1] + q[0][0])
    dp3 = abs(p[3][2] - 2 * p[3][1] + p[3][0])
    dq3 = abs(q[3][2] - 2 * q[3][1] + q[3][0])
    dp03, dq03 = dp0 + dp3, dq0 + dq3
    if not dp03 + dq03 < beta:
        return
    tc5 = (5 * tc + 1) >> 1

    def strong_at(lr, dp, dq):
        return (2 * (dp + dq) < (beta >> 2)
                and abs(p[lr][3] - p[lr][0]) + abs(q[lr][0] - q[lr][3])
                < (beta >> 3)
                and abs(p[lr][0] - q[lr][0]) < tc5)

    c2 = 2 * tc
    if strong_at(0, dp0, dq0) and strong_at(3, dp3, dq3):
        for lr in range(4):
            p3, p2, p1, p0 = p[lr][3], p[lr][2], p[lr][1], p[lr][0]
            q0, q1, q2, q3 = q[lr]
            r = r0 + lr
            s[r, c - 3] = clamp3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                                 p2 - c2, p2 + c2)
            s[r, c - 2] = clamp3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2,
                                 p1 + c2)
            s[r, c - 1] = clamp3(
                (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - c2,
                p0 + c2)
            s[r, c] = clamp3((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                             q0 - c2, q0 + c2)
            s[r, c + 1] = clamp3((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2,
                                 q1 + c2)
            s[r, c + 2] = clamp3((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                                 q2 - c2, q2 + c2)
        return
    side = (beta + (beta >> 1)) >> 3
    th = tc >> 1
    for lr in range(4):
        p2, p1, p0 = p[lr][2], p[lr][1], p[lr][0]
        q0, q1, q2 = q[lr][0], q[lr][1], q[lr][2]
        delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        if not abs(delta) < 10 * tc:
            continue
        dc = clamp3(delta, -tc, tc)
        r = r0 + lr
        s[r, c - 1] = clamp3(p0 + dc, 0, pix_max)
        s[r, c] = clamp3(q0 - dc, 0, pix_max)
        if dp03 < side:
            s[r, c - 2] = clamp3(
                p1 + clamp3((((p2 + p0 + 1) >> 1) - p1 + dc) >> 1, -th, th),
                0, pix_max)
        if dq03 < side:
            s[r, c + 1] = clamp3(
                q1 + clamp3((((q2 + q0 + 1) >> 1) - q1 - dc) >> 1, -th, th),
                0, pix_max)


def filter_chroma(s, r, c, tc, pix_max):
    p1, p0, q0, q1 = (int(s[r, c + k]) for k in (-2, -1, 0, 1))
    delta = clamp3(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, -tc, tc)
    s[r, c - 1] = clamp3(p0 + delta, 0, pix_max)
    s[r, c] = clamp3(q0 - delta, 0, pix_max)


def fused_deblock_model(planes, qps, bit_depth, is_chroma, tile_h=TILE_H,
                        tile_w=TILE_W, halo_rows=True):
    """deblock.cu's schedule: per thread block a tile_h x tile_w tile
    with a HALO-sample halo in 'shared memory' (0 off the plane), the
    vertical pass's (segment, edge) items (on the halo rows too unless
    `halo_rows` is False), then the horizontal pass's on its output (the
    transpose view), then the tile written back."""
    b, h, w = planes.shape
    out = np.empty_like(planes)
    pix_max = (1 << bit_depth) - 1
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
                for g in range(s.shape[0] // 4):
                    if not halo_rows and not HALO <= 4 * g < HALO + tile_h:
                        continue
                    for j in range(tile_w // 8 + 1):
                        k, gy = x0 // 8 + j, y0 - HALO + 4 * g
                        if not 1 <= k <= ctrunc(w - 4, 8):
                            continue
                        if is_chroma:
                            for lr in range(4):
                                if 0 <= gy + lr < h:
                                    filter_chroma(s, 4 * g + lr,
                                                  HALO + 8 * j, tc, pix_max)
                        elif gy >= 0 and gy // 4 < h // 4:
                            filter_luma(s, 4 * g, HALO + 8 * j, beta, tc,
                                        pix_max)
                st = s.T
                for j in range(tile_h // 8 + 1):
                    for g in range(tile_w // 4):
                        k, gx = y0 // 8 + j, x0 + 4 * g
                        if not 1 <= k <= ctrunc(h - 4, 8):
                            continue
                        if is_chroma:
                            for lr in range(4):
                                if gx + lr < w:
                                    filter_chroma(st, HALO + 4 * g + lr,
                                                  HALO + 8 * j, tc, pix_max)
                        elif gx // 4 < w // 4:
                            filter_luma(st, HALO + 4 * g, HALO + 8 * j, beta,
                                        tc, pix_max)
                th, tw = min(tile_h, h - y0), min(tile_w, w - x0)
                out[plane, y0:y0 + th, x0:x0 + tw] = \
                    s[HALO:HALO + th, HALO:HALO + tw]
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


def decide_model(stats, bit_depth, prices=None, merge=True):
    """sao.cu's decision kernels on (B, nty, ntx, 96) statistics: the
    per-plane kernel (prices None: the tiles summed with wrap-around, one
    warp decides) or the CTB kernel (thread blocks of DECIDE_WARPS tiles
    of a row, pass 1 for them and for the tiles above and to the left,
    then the merge pass)."""
    cap = ref_sao.max_offset(bit_depth)
    b, nty, ntx, _ = stats.shape
    if prices is None:
        tot = stats.astype(np.int64).sum(axis=(1, 2))
        tot = ((tot + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int64)
        res = [lanes_decide(t, cap, None) for t in tot]
        return (np.array([r[1] for r in res], np.int32),
                np.array([r[2] for r in res], np.int32),
                np.array([r[3] for r in res], np.int32))
    tmap = np.zeros((b, nty, ntx), np.int32)
    bmap, omap = tmap.copy(), np.zeros((b, nty, ntx, 4), np.int32)
    wn = DECIDE_WARPS
    for p in range(b):
        for ty in range(nty):
            for tx0 in range(0, ntx, wn):
                pass1 = {}
                for job in range(2 * wn + 1 if merge else wn):
                    jy, jx = (ty, tx0 + job) if job < wn else \
                        (ty - 1, tx0 + job - wn) if job < 2 * wn else \
                        (ty, tx0 - 1)
                    if 0 <= jy and 0 <= jx < ntx:
                        pass1[job] = lanes_decide(stats[p, jy, jx], cap,
                                                  prices)
                for w in range(wn):
                    tx = tx0 + w
                    if tx >= ntx:
                        continue
                    best = pass1[w]
                    for has, key in ((tx > 0, w - 1 if w else 2 * wn),
                                     (ty > 0, wn + w)):
                        if not (merge and has):
                            continue
                        _, nt, nb, no = pass1[key]
                        d = F(0.0) if nt == 0 else lanes_params_delta(
                            stats[p, ty, tx], nt, nb, no)
                        cost = F(d + F(prices[3]))
                        if cost < best[0]:
                            best = (cost, nt, nb, list(no))
                    tmap[p, ty, tx], bmap[p, ty, tx] = best[1], best[2]
                    omap[p, ty, tx] = best[3]
    return tmap, bmap, omap


def same(got, want):
    for g, w in zip(got, want, strict=True):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no-merge"])
@pytest.mark.parametrize("h,w,tile", SHAPES + [(40, 300, 16)])
def test_decision_lanes_equal_estimate_sao_ctb(h, w, tile, merge):
    """Wider than DECIDE_WARPS tiles at tile 16, so thread blocks meet
    at a left neighbour computed by the block to their left."""
    src, rec = pair(h, w, 8, h + w)
    stats = lf.sao_statistics_reference(torch.from_numpy(src)[None],
                                        torch.from_numpy(rec)[None], tile)
    got = decide_model(stats.numpy(), 8, lf.sao_prices(27, 0.5), merge)
    same(got, t_ctb.estimate_sao_ctb(torch.from_numpy(src)[None],
                                     torch.from_numpy(rec)[None], tile, 27,
                                     8, 0.5, merge))
    same([g[0] for g in got], j_ctb.estimate_sao_ctb(
        jnp.asarray(src), jnp.asarray(rec), tile, 27, 8, 0.5, merge))


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_decision_lanes_equal_estimate_sao(bit_depth):
    pairs = [pair(48, 64, bit_depth, s) for s in range(3)]
    src = np.stack([p[0] for p in pairs])
    rec = np.stack([p[1] for p in pairs])
    stats = lf.sao_statistics_reference(torch.from_numpy(src),
                                        torch.from_numpy(rec),
                                        lf.FRAME_STATS_TILE, bit_depth)
    got = decide_model(stats.numpy(), bit_depth)
    same(got, t_sao.estimate_sao(torch.from_numpy(src), torch.from_numpy(rec),
                                 bit_depth))
    for i in range(len(pairs)):
        same([g[i] for g in got], j_sao.estimate_sao(
            jnp.asarray(src[i]), jnp.asarray(rec[i]), bit_depth))


def test_decision_lanes_per_plane_sums_wrap():
    """Per-plane sums past int32 wrap as the plain version's do."""
    stats = np.zeros((1, 2, 3, lf.STAT_INTS), np.int32)
    stats[..., 32 + 7] = 400_000_000                   # band 7's count
    stats[..., 64 + 7] = 2_000_000_000                 # and sum
    stats[..., 0] = 1000
    stats[..., 16] = -900_000
    got = decide_model(stats, 10)
    same(got, lf.sao_decide_reference(torch.from_numpy(stats), bit_depth=10))


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
    got = decide_model(st, 8)
    assert (got[0][0], got[1][0]) == (ref_sao.SAO_BO, 9)
    same(got, t_sao.estimate_sao(s, r))
    same([g[0] for g in got], j_sao.estimate_sao(jnp.asarray(src),
                                                 jnp.asarray(rec)))
    for tie_src, scale in ((src, 1.0), (rec, 0.0)):
        ts = torch.from_numpy(tie_src)[None]
        st = lf.sao_statistics_reference(ts, r, 16).numpy()
        got = decide_model(st, 8, lf.sao_prices(22, scale))
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
        got = decide_model(crafted, 8, prices)
        assert (np.asarray(got[0]) == ref_sao.SAO_EO0 + 1).all()
        same(got, lf.sao_decide_reference(torch.from_numpy(crafted),
                                          prices=prices))


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


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 16, 16), dtype=torch.int32, device="meta")
    stats = torch.empty((1, 1, 1, lf.STAT_INTS), dtype=torch.int32,
                        device="meta")
    calls = [lambda: lf.deblock_planes(meta, 22),
             lambda: lf.sao_statistics(meta, meta, 16),
             lambda: lf.sao_decide(stats),
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
