"""A numpy model of the widened wavefront kernel's arithmetic
(`csrc/wavefront.cu` with `mode_sweep.cuh`, `intra_smooth.cuh` and
`rdoq_tail.cuh`), held to the plain versions on the CPU before the card
runs it.  The tolerance is 0 everywhere.

- RDOQ one block at a time as the kernel's tail does it: a thread per
  raster position holding its scan position and rate-table entries for
  each scan kind it keeps (three at N 4 and 8, where scan "mode" picks
  one by the block's mode), read once from the wrapper's table
  (`kernels.wavefront._rdoq_table_array`); numpy float32 operations
  (correctly rounded, never fused); the sums in the kernel's serial
  order, lane by lane as the kernel gives them out (the distortion's
  and the bits' runs of 16 in one branch, the total's runs of 32 in a
  warp of their own, the two carries in one branch; bit for bit
  `ops.rate.ordered_sum` / `ordered_cumsum`, on the padded scratch
  layout); the last position and the first minimum (an int key in float
  order, then the least position) by warp reductions and one exchange
  across the warps, at every thread count that runs the tail.  It must
  equal `ops.rdoq_levels` at N 4 to 32, in every scan, with the dequant
  rescale on and off, at QP 0, 22, 37 and 51, on textured and near-flat
  blocks.
- The row hand-off of self-announcing words: thread blocks taking rows
  by ticket, block steps and each lane's word store interleaved in
  seeded random and extreme orders, == the plain loop; a reader that
  polls only one of its N words differs.
- The decision of every body (one fixed mode, the pair DC / planar, the
  35-mode sweep) under every per-block cost, with the packed (cost,
  rank) key where `packed_min_ok` admits it, on closed-loop references
  (raster order, the availability rule written instead of read) and
  with the filtered references routed by the filter mask.  Each block's
  decision must equal `decide_modes`, and the whole walk, RDOQ
  included, the plain loop `wavefront_encode_planes_reference`.
"""

import numpy as np
import pytest
import torch

from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels import wavefront as kwf
from nanohevc_tpu_torch.kernels.mode_search import angle_table
from nanohevc_tpu_torch.ops.mode_decision import decide_modes
from nanohevc_tpu_torch.ops.rate import ordered_cumsum, ordered_sum
from nanohevc_tpu_torch.ops.rdoq import rd_lambda_calibrated
from nanohevc_tpu_torch.ref.metrics import hadamard_matrix

F32 = np.float32
SIZES = [(4, True), (4, False), (8, False), (16, False), (32, False)]


# --- the RDOQ tail ----------------------------------------------------------

# The kernels' thread counts that run the tail, by N: the wavefront
# kernel's bodies (N*N, or 16N for the search at N=4) and the RD
# kernel's (64, 288, 256, 576, 1024), whose warps are not always a power
# of two.
TAIL_THREADS = {4: (16, 64, 288), 8: (64, 128, 288), 16: (256, 576),
                32: (1024,)}


def mode_scan_kind(modes):
    """rdoq_tail.cuh's mode_scan_kind: vertical (2) for modes 6-14,
    horizontal (1) for 22-30, diagonal (0) otherwise."""
    return np.where((modes >= 6) & (modes <= 14), 2,
                    np.where((modes >= 22) & (modes <= 30), 1, 0))


def rdoq_registers(n, use_dst, scan):
    """rdoq_regs: each pixel's gain, and for each kind it keeps (three at
    N 4 and 8, else one) its scan position and rate-table entries
    there, read once from the wrapper's table.  Returns (g (NN,),
    k / sig0 / sig1 / last_bits (KINDS, NN))."""
    nn = n * n
    tab = kwf._rdoq_table_array(n, use_dst)
    fl = tab[:4 * nn].view(F32)
    gain, sig0_k, sig1_k, last_k = (fl[i * nn:(i + 1) * nn] for i in range(4))
    pos = tab[4 * nn:].reshape(3, nn)
    kinds = 3 if n <= 8 else 1
    sel = [c if scan == "mode" else kwf.SCANS[scan] for c in range(kinds)]
    k = pos[sel]                                       # (KINDS, NN) by raster
    return gain, k, sig0_k[k], sig1_k[k], last_k[k]


def float_key(c):
    """rdoq_tail.cuh's float_key: int32 keys in the order of float32
    compares, -0 made +0 first (c + 0)."""
    i = (np.asarray(c, F32) + F32(0.0)).view(np.int32)
    return np.where(i >= 0, i, i ^ 0x7fffffff)


def warp_argmin(key, k):
    """warp_argmin over the last axis: the least key, then the least k
    of the lanes that hold it (two warp reductions)."""
    least = key.min(axis=-1, keepdims=True)
    return least[..., 0], np.where(key == least, k, 2 ** 31 - 1).min(axis=-1)


def block_reductions(last_in, cost, pos, threads):
    """The tail's two reductions over `threads` threads (thread t holds
    pixel t % NN): the warp's max then one exchange, and the warp's first
    minimum of (float_key(cost), scan position) then one exchange (lane L
    reading warp L's entry, or warp 0's past the last warp).  Returns
    (last, best cost, best_k), each (nb,), as every thread ends with
    them."""
    pix = np.arange(threads) % pos.shape[1]
    warps = max(threads // 32, 1)
    lanes = min(threads, 32)
    v = last_in[:, pix].reshape(-1, warps, lanes)
    key = float_key(cost[:, pix]).reshape(-1, warps, lanes)
    kk = pos[:, pix].reshape(-1, warps, lanes)
    s_last = v.max(axis=2)                              # (nb, warps)
    s_min_key, s_min_k = warp_argmin(key, kk)
    if warps > 1:
        entry = np.arange(32)
        entry = np.where(entry < warps, entry, 0)
        s_last = s_last[:, entry]
        s_min_key, s_min_k = warp_argmin(s_min_key[:, entry],
                                         s_min_k[:, entry])
    else:
        s_min_key, s_min_k = s_min_key[:, 0], s_min_k[:, 0]
    best = np.where(s_min_key >= 0, s_min_key, s_min_key ^ 0x7fffffff)
    return s_last.max(axis=1), best.astype(np.int32).view(F32), s_min_k


def padded(k):
    """rdoq_tail.cuh's padded(k): a pad word after every 16 positions."""
    return k + (k >> 4)


def lane_runs(zg, cc, nn):
    """Stage B as the kernel's lanes run it, on the padded scratch arrays
    (scan position k at padded(k)), each lane a serial float32 loop
    (numpy float32 adds: correctly rounded, never fused): lanes r <
    NN/16 take run r of the distortion from its padded start 17 r into
    czg, lanes NN/16 + r run r of the bits in place, through the array
    their lane chooses; the total's runs of 32 (from 34 q, the second
    half from 34 q + 17) in the lanes of the next warp; then lane 0 and
    lane 1 carry the distortion's and the bits' run totals, and the
    first lane of the runs of 32 sums them.  Returns (total, cum_zg,
    cum_cc), by scan position (cum_* with the carries added)."""
    nb = zg.shape[0]
    pos = padded(np.arange(nn))
    words = nn + nn // 16
    s_zg = np.full((nb, words), np.nan, F32)
    s_cc = np.full((nb, words), np.nan, F32)
    s_czg = np.full((nb, words), np.nan, F32)
    s_zg[:, pos], s_cc[:, pos] = zg, cc
    if nn <= 16:                        # lanes 0 and 1: one scan each
        for lane in (0, 1):
            src, dst = (s_zg, s_czg) if lane == 0 else (s_cc, s_cc)
            v = src[:, :nn].copy()      # every load before the stores
            acc = v[:, 0]
            dst[:, 0] = acc
            for e in range(1, nn):
                acc = acc + v[:, e]
                dst[:, e] = acc
            if lane == 0:
                total = acc
        return total, s_czg[:, pos], s_cc[:, pos]
    nr16, nr32 = nn // 16, nn // 32
    s_tot = np.empty((nb, 2 * nr16), F32)
    for lane in range(2 * nr16):        # one branch, the array by lane
        bits = lane >= nr16
        b = 17 * (lane - nr16 if bits else lane)
        src, dst = (s_cc, s_cc) if bits else (s_zg, s_czg)
        v = src[:, b:b + 16].copy()
        acc = v[:, 0]
        dst[:, b] = acc
        for e in range(1, 16):
            acc = acc + v[:, e]
            dst[:, b + e] = acc
        s_tot[:, lane] = acc
    s_run32 = np.empty((nb, nr32), F32)
    for r in range(nr32):               # the total's runs, another warp
        src = s_zg[:, 34 * r:]
        acc = src[:, 0].copy()
        for e in range(1, 16):
            acc = acc + src[:, e]
        for e in range(16):
            acc = acc + src[:, 17 + e]
        s_run32[:, r] = acc
    s_carry = np.zeros((nb, 2 * nr16), F32)
    for lane in (0, 1):                 # one branch, the array by lane
        src = s_tot[:, lane * nr16:]
        acc = src[:, 0].copy()
        s_carry[:, lane * nr16] = acc
        for r in range(1, nr16 - 1):
            acc = acc + src[:, r]
            s_carry[:, lane * nr16 + r] = acc
    total = s_run32[:, 0].copy()
    for r in range(1, nr32):
        total = total + s_run32[:, r]
    czg, ccc = s_czg[:, pos], s_cc[:, pos]
    assert not np.isnan(czg).any() and not np.isnan(ccc).any()
    run = np.arange(nn) // 16
    carry_zg = np.where(run > 0, s_carry[:, np.maximum(run - 1, 0)], 0)
    carry_cc = np.where(run > 0, s_carry[:, nr16 + np.maximum(run - 1, 0)], 0)
    cum_zg = np.where(run > 0, (carry_zg + czg).astype(F32), czg)
    cum_cc = np.where(run > 0, (carry_cc + ccc).astype(F32), ccc)
    return total, cum_zg, cum_cc


def rdoq_model(coeff, level, modes, n, qp, use_dst, rescale, scan, scale,
               sums=None, threads=None):
    """rdoq_tail.cuh on (nb, N*N) raster coefficients and deadzone levels
    (and the blocks' modes, for scan "mode"): (nb, N*N) raster levels,
    with the reductions of a block of `threads` threads (N*N by
    default).  A dict passed as `sums` receives the sums' inputs and
    results by scan position (zg, cc, total, cum_zg, cum_cc)."""
    nn = n * n
    g1, k_kind, s0_kind, s1_kind, lb_kind = rdoq_registers(n, use_dst, scan)
    lam, lam_cbf0, cbf1, g10, g11, g20, g21 = kwf.rdoq_scalars(
        qp, n, use_dst, rescale, scale)
    q = kwf.qp_scalars(qp, n, 8, rescale)
    nb = coeff.shape[0]
    # the kind of each block: its mode's under scan "mode" at N 4 and 8
    kind = (mode_scan_kind(modes) if scan == "mode" and n <= 8
            else np.zeros(nb, np.int64))
    k = k_kind[kind]                                    # (nb, NN) by raster
    sig0, sig1, lastb = s0_kind[kind], s1_kind[kind], lb_kind[kind]
    g = g1[None, :]
    a = np.abs(level).astype(np.int64)
    sgn = np.sign(level).astype(np.int64)
    last_in = np.where(a > 0, k, -1)
    cost_pending = np.zeros((nb, nn), F32)          # filled after stage B
    last, _, _ = block_reductions(last_in, cost_pending, k, threads or nn)
    last = np.where(last < 0, nn - 1, last)[:, None]

    def deq(lv):
        base = (lv * q.dscale).astype(np.int32).astype(np.int64)
        if q.dq_shift >= 1:
            return (base + (1 << (q.dq_shift - 1))) >> q.dq_shift
        return (base << -q.dq_shift).astype(np.int32)

    cf = coeff.astype(F32)

    def dist(aa):
        d = cf - deq(sgn * aa).astype(F32)
        return (g * d) * d

    def rate(aa):
        x = np.maximum(aa - 2, 1)
        e = np.floor(np.log2(x.astype(np.float64))).astype(np.int64)
        e = e - np.isin(x, (8192, 32768)) + np.isin(x, (2097151, 4194303))
        eg0 = F32(2.0) * e.astype(F32) + F32(1.0)
        gt = np.where(aa > 1, g11 + np.where(aa > 2, g21 + eg0, g20), g10)
        return np.where(aa > 0, (sig1 + F32(1.0)) + gt, sig0).astype(F32)

    down = np.maximum(a - 1, 0)
    dd, rd, da, ra = dist(down), rate(down), dist(a), rate(a)
    trim = (a > 0) & ((a > 1) | (k < last)) & (dd + lam * rd < da + lam * ra)
    kept = np.where(trim, down, a)
    ccoef = np.where(trim, rd, ra)
    rows = np.arange(nb)[:, None]
    zg = np.empty((nb, nn), F32)
    cc = np.empty((nb, nn), F32)
    zg[rows, k] = ((g * cf) * cf) - np.where(trim, dd, da)
    cc[rows, k] = ccoef
    total, czg, ccc = lane_runs(zg, cc, nn)
    if sums is not None:
        sums.update(zg=zg, cc=cc, total=total, cum_zg=czg, cum_cc=ccc)
    cum_zg, cum_cc = czg[rows, k], ccc[rows, k]
    suffix = total[:, None] - cum_zg
    prefix = cum_cc - ccoef
    rate_p = ((cbf1 + lastb) + prefix) + (ccoef - sig1)
    cost = np.where(kept > 0, lam * rate_p + suffix, F32(np.inf)).astype(F32)
    _, best, best_k = block_reductions(last_in, cost, k, threads or nn)
    all_zero = (lam_cbf0 + total) <= best
    keep = (k <= best_k[:, None]) & ~all_zero[:, None]
    return np.where(keep, sgn * kept, 0).astype(np.int32)


def seeded_blocks(seed, nb, n, bit_depth=8):
    """Residual blocks against their mean: textured (ramps, edges, noise)
    and near-flat ones (a few levels of noise: the near-ties)."""
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:n, 0:n]
    out = []
    for i in range(nb):
        if i % 2:
            amp = int(rng.choice([1, 2, 4, 8]))
            b = (rng.integers(-amp, amp + 1, (n, n))
                 + xx * rng.integers(-1, 2))
        else:
            gx, gy = rng.integers(-12, 13, 2)
            edge = ((xx + yy * rng.integers(-2, 3) > n // 2)
                    * rng.integers(-90, 91))
            b = gx * xx + gy * yy + edge + rng.integers(-30, 31, (n, n))
        b = np.clip(b * max(1, peak // 255), -peak, peak)
        out.append(b - int(b.mean()))
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("n,use_dst", SIZES,
                         ids=[f"n={n}{'-dst' if d else ''}" for n, d in SIZES])
def test_rdoq_model_matches_rdoq_levels(n, use_dst, rescale):
    """The tail's lanes (the joint runs branch, the joint carries, the
    total's runs in a warp of their own), its registers by scan kind and
    its warp reductions with one exchange, at every thread count that
    runs it == ops.rdoq_levels, and its sums == ordered_sum /
    ordered_cumsum bit for bit."""
    nb = 24 if n == 32 else 48
    blocks = torch.from_numpy(seeded_blocks(n * 10 + rescale, nb, n))
    coeff = ops.forward_transform(blocks, use_dst)
    rng = np.random.default_rng(n)
    modes = torch.from_numpy(rng.integers(0, 35, nb).astype(np.int32))
    gain = ops.rdoq_gain(n, use_dst).expand(coeff.shape)
    changed = 0
    for qp in (0, 22, 37, 51):
        levels = ops.quantize(coeff, qp, n)
        for scan in ("diag", "horizontal", "vertical", "mode"):
            for scale in (1.0, 8.0):
                lam = rd_lambda_calibrated(qp, n, use_dst, rescale, scale)
                want = ops.scan_unpack(ops.rdoq_levels(
                    ops.scan_pack(coeff, scan, modes=modes),
                    ops.scan_pack(levels, scan, modes=modes),
                    ops.scan_pack(gain, scan, modes=modes), qp, n, lam,
                    dequant_rescale=rescale), scan, modes=modes)
                sums = {}
                for threads in TAIL_THREADS[n]:
                    got = rdoq_model(coeff.reshape(nb, -1).numpy(),
                                     levels.reshape(nb, -1).numpy(),
                                     modes.numpy(), n, qp, use_dst, rescale,
                                     scan, scale, sums, threads)
                    assert np.array_equal(got.reshape(nb, n, n),
                                          want.numpy()), (qp, scan, scale,
                                                          threads)
                # the serial runs give the plain version's sums bit for bit
                zg, cc = (torch.from_numpy(sums[x]) for x in ("zg", "cc"))
                for mine, plain in (
                        (sums["total"], ordered_sum(zg)),
                        (sums["cum_zg"], ordered_cumsum(zg)),
                        (sums["cum_cc"], ordered_cumsum(cc))):
                    assert mine.tobytes() == plain.numpy().tobytes()
                changed += int((want != levels).any(dim=(1, 2)).sum())
    assert changed > 0                  # RDOQ moved some blocks


def test_float_key_keeps_float_order():
    """The minimum's int keys order and equate float32 values as float
    compares do: -0 == +0, negatives, subnormals, infinities."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.0, -1.0,
                  np.finfo(F32).max, -np.finfo(F32).max], F32),
        rng.normal(0, 1e3, 200).astype(F32),
        (rng.integers(-5, 6, 50) * F32(0.25)).astype(F32)])
    a, b = np.meshgrid(vals, vals)
    ka, kb = float_key(a), float_key(b)
    assert np.array_equal(a < b, ka < kb)
    assert np.array_equal(a == b, ka == kb)
    back = np.where(ka >= 0, ka, ka ^ 0x7fffffff).astype(np.int32).view(F32)
    assert np.array_equal(back == a, np.ones_like(a, bool))


def test_rdoq_tables_layout():
    """The table the kernel reads: gain by raster position, rate-table
    entries by scan position, and the inverse scans."""
    n = 8
    tab = kwf._rdoq_table_array(n, False)
    assert tab.dtype == np.int32 and tab.shape == (7 * n * n,)
    assert np.array_equal(tab[:64].view(F32),
                          ops.rdoq_gain(n, False).numpy().reshape(-1))
    order = ops.scan_pack(torch.arange(64, dtype=torch.int32).reshape(1, 8, 8),
                          "vertical")[0].numpy()
    assert np.array_equal(tab[4 * 64 + 2 * 64:][order], np.arange(64))
    assert kwf.rdoq_scalars(22, n, False, False, 1.0).dtype == F32


# --- the bodies' decisions on closed-loop references -----------------------

def smoothed(ref, n, bit_depth):
    """intra_smooth.cuh, one sample at a time."""
    r_ = 2 * n + 1
    thresh = 1 << (bit_depth - 5)
    out = np.empty_like(ref)
    c = ref[0]
    flat = (abs(c + ref[2 * n] - 2 * ref[n]) < thresh
            and abs(c + ref[r_ + 2 * n] - 2 * ref[r_ + n]) < thresh)
    for t in range(2 * r_):
        arm = 0 if t < r_ else r_
        k = t - arm
        a = ref[arm:arm + r_]
        if k == 0:
            v = (ref[r_ + 1] + 2 * ref[0] + ref[1] + 2) >> 2
        elif k == 2 * n:
            v = a[2 * n]
        else:
            v = (a[k - 1] + 2 * a[k] + a[k + 1] + 2) >> 2
        if n == 32 and flat:
            v = c if k == 0 else ((2 * n - k) * c + k * a[2 * n] + n) >> 6
        out[t] = v
    return out


def predict(ref, mode, n):
    """mode_sweep.cuh's predictors: planar_pixel, dc_value, and the
    projection array with angular_pixel."""
    r_ = 2 * n + 1
    ii, jj = np.mgrid[0:n, 0:n]
    top, left = ref[:r_], ref[r_:]
    if mode == 0:
        return ((n - 1 - jj) * left[1 + ii] + (jj + 1) * top[n]
                + (n - 1 - ii) * top[1 + jj] + (ii + 1) * left[n]
                + n) >> n.bit_length()
    if mode == 1:
        return np.full((n, n), (top[1:n + 1].sum() + left[1:n + 1].sum() + n)
                       // (2 * n))
    tab = angle_table().astype(np.int64)
    angle, inv = int(tab[mode - 2]), int(tab[33 + mode - 2])
    vertical = mode >= 18
    prim, sec = (0, r_) if vertical else (r_, 0)
    proj = np.empty(3 * n + 1, np.int64)
    for e in range(3 * n + 1):
        p = e - n
        if p >= 0:
            proj[e] = ref[prim + p]
        elif angle < 0 and p >= (n * angle) >> 5:
            proj[e] = ref[sec + (((p + 1) * inv + 128) >> 8)]
        else:
            proj[e] = ref[0]
    scan_, base = (ii, jj) if vertical else (jj, ii)
    pp = (scan_ + 1) * angle
    frac = pp & 31
    idx = n + base + 1 + (pp >> 5)
    a, b = proj[idx], proj[np.minimum(idx + 1, 3 * n)]
    return ((32 - frac) * a + frac * b + 16) >> 5


def wrap32(x):
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def cost_of(res, decision, n):
    if decision == "satd":
        h = hadamard_matrix(n).astype(np.int64)
        return wrap32(np.abs(h @ res @ h.T).sum())
    if decision == "sad":
        return wrap32(np.abs(res).sum())
    return wrap32(((res * res) & 0xFFFFFFFF).sum())   # int32 squares, wrapped


def packed_ok(decision, n, max_pix):
    bound = {"satd": n ** 3 * max_pix, "sad": n * n * max_pix,
             "energy": n * n * max_pix * max_pix}[decision]
    return bound * 64 + 34 < (1 << 31)


def decide_model(x, ref, n, mode_set, decision, bit_depth, smoothing):
    """The kernel's decision for one block: (pred, mode)."""
    mask = kwf.filter_mask(n, smoothing and n > 4)
    fref = smoothed(ref, n, bit_depth) if mask else ref

    def refs_of(mode):
        return fref if (mask >> mode) & 1 else ref

    if mode_set in ("dc", "planar"):
        mode = kwf.FIXED_MODES[mode_set]
        return predict(refs_of(mode), mode, n), mode
    if mode_set == "dc_planar" and decision == "energy":   # K4's body
        e = {m: cost_of(x - predict(refs_of(m), m, n), "energy", n)
             for m in (0, 1)}
        mode = 1 if e[1] <= e[0] else 0
        return predict(refs_of(mode), mode, n), mode
    # the sweep: ranks are modes (35) or DC 0, planar 1 (the pair)
    cands = list(range(35)) if mode_set == "all" else [1, 0]
    costs = [cost_of(x - predict(refs_of(m), m, n), decision, n)
             for m in cands]
    if packed_ok(decision, n, (1 << bit_depth) - 1):
        keys = [wrap32(c * 64 + r) for r, c in enumerate(costs)]
        rank = min(keys) & 63
    else:
        rank = min(range(len(cands)), key=lambda r: (costs[r], r))
    mode = cands[rank]
    return predict(refs_of(mode), mode, n), mode


def kernel_walk(planes, qp, n, mode_set, decision, bit_depth, use_dst,
                smoothing=False, rdoq=False, scan="diag", rescale=False):
    """wavefront.cu's algorithm: blocks in raster order, references by
    the availability rule with the extensions written, never read; the
    model's decision, checked against decide_modes on the same
    references; the tail through the plain ops, RDOQ through the model."""
    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    r_ = 2 * n + 1
    boundary, max_pix = 1 << (bit_depth - 1), (1 << bit_depth) - 1
    recon = np.zeros((b, hp, wp), np.int64)
    levels = np.zeros((b, nby * nbx, n, n), np.int32)
    modes = np.zeros((b, nby * nbx), np.int32)
    for f in range(b):
        rec = recon[f]
        for by in range(nby):
            for bx in range(nbx):
                y0, x0 = by * n, bx * n
                ref = np.zeros(2 * r_, np.int64)
                if by == 0:
                    ref[:r_] = boundary
                else:
                    ref[1:n + 1] = rec[y0 - 1, x0:x0 + n]
                    ref[n + 1:r_] = (rec[y0 - 1, x0 + n - 1]
                                     if bx == nbx - 1 else 0)
                if bx == 0:
                    ref[r_:] = boundary
                else:
                    ref[r_ + 1:r_ + n + 1] = rec[y0:y0 + n, x0 - 1]
                    ref[r_ + n + 1:] = (rec[y0 + n - 1, x0 - 1]
                                        if by == nby - 1 else 0)
                ref[0] = ref[r_] = (boundary if by == 0 or bx == 0
                                    else rec[y0 - 1, x0 - 1])
                x = planes[f, y0:y0 + n, x0:x0 + n].astype(np.int64)
                pred, mode = decide_model(x, ref, n, mode_set, decision,
                                          bit_depth, smoothing)
                want_pred, want_mode = decide_modes(
                    torch.from_numpy(x.astype(np.int32))[None],
                    torch.from_numpy(ref.astype(np.int32))[None], n,
                    mode_set, decision, smoothing=smoothing,
                    bit_depth=bit_depth)
                assert mode == int(want_mode[0]), (by, bx)
                assert np.array_equal(pred, want_pred[0].numpy()), (by, bx)
                blk = torch.from_numpy((x - pred).astype(np.int32))[None]
                coeff = ops.forward_transform(blk, use_dst)
                lev = ops.quantize(coeff, qp, n)
                if rdoq:
                    lev = torch.from_numpy(rdoq_model(
                        coeff.reshape(1, -1).numpy(),
                        lev.reshape(1, -1).numpy(), np.array([mode]), n, qp,
                        use_dst, rescale, scan, 1.0).reshape(1, n, n))
                res = ops.inverse_transform(
                    ops.dequantize(lev, qp, n, rescale=rescale), use_dst)
                rec[y0:y0 + n, x0:x0 + n] = np.clip(pred + res[0].numpy(),
                                                    0, max_pix)
                levels[f, by * nbx + bx] = lev[0].numpy()
                modes[f, by * nbx + bx] = mode
    return recon.astype(np.int32), levels, modes


def textured(b, h, w, seed, bit_depth):
    """Ramps, waves and noise with flat patches (where DC, planar and
    many angular modes tie)."""
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(b):
        a, c = rng.integers(-6, 7, 2)
        wave = 40 * np.sin(xx / rng.uniform(3, 9) + yy / rng.uniform(3, 9))
        x = 128 + a * yy + c * xx + wave + rng.integers(-6, 7, (h, w))
        x = x * (peak / 255)
        flat = (xx // 8 + yy // 8) % 3 == 0
        out.append(np.clip(np.where(flat, peak // 2, x), 0, peak))
    return np.stack(out).astype(np.int32)


BODIES = [(ms, dec) for ms in ("dc", "planar", "dc_planar", "all")
          for dec in ("energy", "sad", "satd")]
# (n, use_dst, (blocks down, across)), shared geometries
WALKS = [(4, True, (3, 4)), (8, False, (2, 3)), (16, False, (2, 2)),
         (32, False, (1, 2))]


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("n,use_dst,blocks", WALKS,
                         ids=[f"n={w[0]}" for w in WALKS])
def test_bodies_match_decide_modes_and_the_plain_loop(n, use_dst, blocks,
                                                      bit_depth):
    """Every (mode set, decision), smoothing off and on (rotated), and
    RDOQ in a rotating scan on a third of them: the model's decisions
    == decide_modes block by block, its outputs == the plain loop."""
    h, w = blocks[0] * n, blocks[1] * n
    planes = textured(1, h, w, n + bit_depth, bit_depth)
    scans = ["diag", "horizontal", "vertical", "mode"]
    for c, (mode_set, decision) in enumerate(BODIES):
        smoothing = n > 4 and c % 2 == 1
        rdoq = (c // 3 + c) % 3 == 0
        scan = scans[c % 4]
        rescale = c % 4 == 1
        qp = (22, 37, 30)[c % 3]
        rec, lev, modes = kernel_walk(planes, qp, n, mode_set, decision,
                                      bit_depth, use_dst, smoothing, rdoq,
                                      scan, rescale)
        want = kwf.wavefront_encode_planes_reference(
            torch.from_numpy(planes), qp, n, mode_set=mode_set,
            decision=decision, bit_depth=bit_depth, use_dst=use_dst,
            dequant_rescale=rescale, intra_smoothing=smoothing, rdoq=rdoq,
            scan=scan)
        for name, got in (("recon", rec), ("levels", lev), ("modes", modes)):
            assert np.array_equal(got, want[name].numpy()), \
                (mode_set, decision, name)


def test_packed_key_bounds():
    """Where the kernel packs (cost, rank) into one int32: SATD and SAD
    at every N and bit depth up to 12 at N <= 8; energy not at N=32 or
    10 bits above N=4."""
    assert packed_ok("satd", 8, 255) and packed_ok("sad", 32, 4095)
    assert packed_ok("energy", 16, 255) and not packed_ok("energy", 32, 255)
    assert packed_ok("energy", 4, 1023) and not packed_ok("energy", 8, 1023)
    assert not packed_ok("satd", 32, 65535)


def test_energy_wraps_as_the_plain_cost():
    """At 16 bits the energy of a 32x32 block wraps in int32; the
    model's wrapped sum is the plain cost's."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 65536, (1, 32, 32)).astype(np.int32)
    pred = np.zeros_like(x)
    want = int(ops.residual_energy_blocks(torch.from_numpy(x - pred))[0])
    got = cost_of((x[0] - pred[0]).astype(np.int64), "energy", 32)
    assert got == want
    assert got != int(((x.astype(np.int64)) ** 2).sum())


# --- the row hand-off: self-announcing words ---------------------------------

def plain_block(x, ref, n, qp, kw):
    """One block coded by the plain ops: (recon (N, N), levels (N, N),
    mode)."""
    pred, mode = decide_modes(torch.from_numpy(x.astype(np.int32))[None],
                              torch.from_numpy(ref.astype(np.int32))[None],
                              n, kw["mode_set"], kw["decision"])
    lev, rec = kwf.code_residual(
        torch.from_numpy(x.astype(np.int32))[None], pred, qp, n,
        use_dst=kw.get("use_dst", False), rdoq=kw.get("rdoq", False),
        scan=kw.get("scan", "diag"), modes=mode)
    return rec[0].numpy().astype(np.int64), lev[0].numpy(), int(mode[0])


def word_schedule(planes, qp, n, kw, *, grid, seed, policy="random",
                  reader="own"):
    """wavefront.cu's row schedule in numpy, its steps taken in an order
    that the words it polls allow: `grid` thread blocks take rows by
    ticket, (by outer, plane inner), and a new ticket once their row is
    done.  A block (by, bx) goes ahead once the words it polls are
    nonzero, builds its top arm from the edge buffer's words (pixel + 1),
    its left arm and corner from what its thread block kept, codes the
    block, and publishes its bottom row: each of the N lanes' stores is
    an event of its own, seen later in any order.  After a block its lanes
    read the next block's words as they are (the kernel's prefetch) and
    poll only those still unwritten.  `reader` "own": lane t
    polls word x0 + t, as the kernel does; "first": only word x0 is
    polled and the rest read as they are (a reader that does not poll
    its own words).  `policy` picks the next event: "random" (seeded),
    "lowest" or "highest" ticket first.  With the own words it asserts
    that every word read was written, by the block above, with its
    pixel, and each word once.  Returns (recon, levels, modes)."""
    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    r_ = 2 * n + 1
    boundary = 128
    rng = np.random.default_rng(seed)
    recon = np.full((b, hp, wp), -1, np.int64)
    levels = np.zeros((b, nby * nbx, n, n), np.int32)
    modes = np.zeros((b, nby * nbx), np.int32)
    edge = np.zeros((b, max(nby - 1, 0), wp), np.int64)   # zeroed once
    blocks = [None] * grid              # a thread block's row, or None
    pending = []                        # (ticket, f, line, x) word stores
    ticket = 0

    def ready(tb):
        f, by, bx = tb["f"], tb["by"], tb["bx"]
        if by == 0:
            return True
        words = np.where(tb["ahead"] != 0, tb["ahead"],
                         edge[f, by - 1, bx * n:(bx + 1) * n])
        return bool(words[0] != 0) if reader == "first" else bool(
            (words != 0).all())

    def step(tb):
        f, by, bx = tb["f"], tb["by"], tb["bx"]
        y0, x0 = by * n, bx * n
        ref = np.zeros(2 * r_, np.int64)
        if by == 0:
            ref[:r_] = boundary
        else:                           # the prefetched words, else polled
            live = edge[f, by - 1, x0:x0 + n]
            top = np.where(tb["ahead"] != 0, tb["ahead"], live) - 1
            if reader == "own":
                assert np.array_equal(top, recon[f, y0 - 1, x0:x0 + n]), (
                    "a word read that the block above did not write")
            ref[1:n + 1] = top
            ref[n + 1:r_] = top[n - 1] if bx == nbx - 1 else 0
        if bx == 0:
            ref[r_:] = boundary
        else:
            ref[r_ + 1:r_ + n + 1] = tb["right"]
            ref[r_ + n + 1:] = tb["right"][n - 1] if by == nby - 1 else 0
        ref[0] = ref[r_] = (boundary if by == 0 or bx == 0 else tb["corner"])
        rec, lev, mode = plain_block(planes[f, y0:y0 + n, x0:x0 + n], ref, n,
                                     qp, kw)
        if by < nby - 1:                # the N lanes' stores, seen later
            pending.extend((tb["ticket"], f, by, x0 + j, rec[n - 1, j] + 1)
                           for j in range(n))
        recon[f, y0:y0 + n, x0:x0 + n] = rec
        levels[f, by * nbx + bx] = lev
        modes[f, by * nbx + bx] = mode
        tb["corner"], tb["right"] = ref[n], rec[:, n - 1]
        tb["bx"] += 1
        if by > 0 and bx + 1 < nbx:     # the next block's words, as they are
            tb["ahead"] = edge[f, by - 1, x0 + n:x0 + 2 * n].copy()

    while True:
        moves = []
        for g, tb in enumerate(blocks):
            if tb is None or tb["bx"] == nbx:
                if ticket < b * nby:
                    moves.append((ticket, "take", g))
            elif ready(tb):
                moves.append((tb["ticket"], "step", g))
        moves += [(w[0], "store", i) for i, w in enumerate(pending)]
        if not moves:
            break
        if policy == "random":
            key, what, arg = moves[rng.integers(len(moves))]
        else:
            pick = min if policy == "lowest" else max
            key, what, arg = pick(moves, key=lambda m: (m[0], m[1] != "store"))
        if what == "take":
            blocks[arg] = dict(ticket=ticket, f=ticket % b, by=ticket // b,
                               bx=0, corner=boundary, right=None,
                               ahead=np.zeros(n, np.int64))
            ticket += 1
        elif what == "step":
            step(blocks[arg])
        else:
            _, f, line, x, word = pending.pop(arg)
            assert edge[f, line, x] == 0, "a word written twice"
            edge[f, line, x] = word
    assert ticket == b * nby and not pending
    assert all(tb is None or tb["bx"] == nbx for tb in blocks), (
        "the schedule stopped with blocks left")
    return recon.astype(np.int32), levels, modes


# (n, use_dst, blocks down, across, batch, grid, policy, keywords): N 4-32,
# grids of 1 to 3 and more than the rows, each order, RDOQ in a scan.
SCHEDULE_CASES = [
    (4, True, 4, 5, 2, 2, "random", dict(mode_set="dc_planar",
                                         decision="energy")),
    (4, False, 3, 6, 1, 1, "lowest", dict(mode_set="all", decision="sad",
                                          rdoq=True, scan="mode")),
    (8, False, 4, 3, 3, 3, "random", dict(mode_set="dc_planar",
                                          decision="satd", rdoq=True)),
    (8, False, 3, 4, 2, 8, "highest", dict(mode_set="dc", decision="energy",
                                           rdoq=True, scan="vertical")),
    (16, False, 3, 2, 1, 2, "random", dict(mode_set="all", decision="satd",
                                           rdoq=True, scan="horizontal")),
    (32, False, 2, 2, 2, 1, "random", dict(mode_set="planar",
                                           decision="energy", rdoq=True)),
]


@pytest.mark.parametrize(
    "n,use_dst,nby,nbx,batch,grid,policy,kw", SCHEDULE_CASES,
    ids=[f"n{c[0]}-{c[2]}x{c[3]}-b{c[4]}-g{c[5]}-{c[6]}"
         for c in SCHEDULE_CASES])
def test_word_hand_off_matches_plain(n, use_dst, nby, nbx, batch, grid,
                                     policy, kw):
    """The kernel's row schedule with the self-announcing words, in an
    order its polls allow (seeded random, lowest or highest ticket first),
    == the plain diagonal walk, recon, levels and modes."""
    planes = textured(batch, nby * n, nbx * n, 5 * n + grid, 8)
    kw = dict(kw, use_dst=use_dst)
    got = word_schedule(planes, 30, n, kw, grid=grid, seed=nby + grid,
                        policy=policy)
    want = kwf.wavefront_encode_planes_reference(torch.from_numpy(planes), 30,
                                                 n, **kw)
    for name, mine in zip(("recon", "levels", "modes"), got):
        assert np.array_equal(mine, want[name].numpy()), name


@pytest.mark.parametrize("n", [4, 8])
def test_word_hand_off_reader_of_one_word_differs(n):
    """The model has teeth: a row that polls only the first word of the
    block above and reads the other N - 1 as they are goes ahead while
    some are still unwritten, and its recon differs from the plain walk
    under random interleavings."""
    planes = textured(1, 3 * n, 4 * n, n, 8)
    kw = dict(mode_set="dc_planar", decision="energy")
    want = kwf.wavefront_encode_planes_reference(torch.from_numpy(planes), 30,
                                                 n, **kw)["recon"].numpy()
    differ = 0
    for seed in range(6):
        recon, _, _ = word_schedule(planes, 30, n, kw, grid=3, seed=seed,
                                    reader="first")
        differ += not np.array_equal(recon, want)
    assert differ > 0
