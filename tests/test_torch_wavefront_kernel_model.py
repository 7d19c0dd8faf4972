"""A numpy model of the widened wavefront kernel's arithmetic
(`csrc/wavefront.cu` with `mode_sweep.cuh`, `intra_smooth.cuh` and
`rdoq_tail.cuh`), held to the plain versions on the CPU before the card
runs it.  The tolerance is 0 everywhere.

- RDOQ one block at a time as the kernel's tail does it: a thread per
  raster position reading its scan position and rate-table entries from
  the wrapper's table (`kernels.wavefront._rdoq_table_array`), numpy
  float32 operations (correctly rounded, never fused), the sums in the
  kernel's serial order (runs of 16 and 32, then the runs; bit for bit
  `ops.rate.ordered_sum` / `ordered_cumsum`), the first minimum by
  float compares.  It must equal `ops.rdoq_levels` at N 4 to
  32, in every scan, with the dequant rescale on and off, at QP 0, 22,
  37 and 51, on textured and near-flat blocks.
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
from nanohevc_tpu_torch.models.all_intra import decide_modes
from nanohevc_tpu_torch.ops.rate import ordered_cumsum, ordered_sum
from nanohevc_tpu_torch.ops.rdoq import rd_lambda_calibrated
from nanohevc_tpu_torch.ref.metrics import hadamard_matrix

F32 = np.float32
SIZES = [(4, True), (4, False), (8, False), (16, False), (32, False)]


# --- the RDOQ tail ----------------------------------------------------------

def rdoq_model(coeff, level, modes, n, qp, use_dst, rescale, scan, scale,
               sums=None):
    """rdoq_tail.cuh on (nb, N*N) raster coefficients and deadzone levels
    (and the blocks' modes, for scan "mode"): (nb, N*N) raster levels.
    A dict passed as `sums` receives the sums' inputs and results by
    scan position (zg, cc, total, cum_zg, cum_cc)."""
    nn = n * n
    tab = kwf._rdoq_table_array(n, use_dst)
    fl = tab[:4 * nn].view(F32)
    gain, sig0_k, sig1_k, last_k = (fl[i * nn:(i + 1) * nn] for i in range(4))
    pos = tab[4 * nn:].reshape(3, nn)
    lam, lam_cbf0, cbf1, g10, g11, g20, g21 = kwf.rdoq_scalars(
        qp, n, use_dst, rescale, scale)
    q = kwf.qp_scalars(qp, n, 8, rescale)
    nb = coeff.shape[0]
    if scan == "mode" and n <= 8:
        kind = np.where((modes >= 6) & (modes <= 14), 2,
                        np.where((modes >= 22) & (modes <= 30), 1, 0))
    else:
        kind = np.full(nb, kwf.SCANS["diag" if scan == "mode" else scan])
    k = pos[kind]                                       # (nb, NN) by raster
    g = gain[None, :]
    sig0, sig1, lastb = sig0_k[k], sig1_k[k], last_k[k]
    a = np.abs(level).astype(np.int64)
    sgn = np.sign(level).astype(np.int64)
    last = np.where(a > 0, k, -1).max(axis=1, keepdims=True)
    last = np.where(last < 0, nn - 1, last)

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

    def runs(x, length):
        """Each run of `length` scanned serially, the runs side by side."""
        x = x.reshape(nb, -1, length)
        out = np.empty_like(x)
        acc = x[:, :, 0]
        out[:, :, 0] = acc
        for e in range(1, length):
            acc = acc + x[:, :, e]
            out[:, :, e] = acc
        return out

    if nn <= 16:
        czg, ccc = runs(zg, nn)[:, 0], runs(cc, nn)[:, 0]
        total = czg[:, -1]
    else:
        szg, scc = runs(zg, 16), runs(cc, 16)
        carry_zg, carry_cc = runs(szg[:, :-1, 15], nn // 16 - 1)[:, 0], \
            runs(scc[:, :-1, 15], nn // 16 - 1)[:, 0]
        szg[:, 1:] = carry_zg[:, :, None] + szg[:, 1:]
        scc[:, 1:] = carry_cc[:, :, None] + scc[:, 1:]
        czg, ccc = szg.reshape(nb, nn), scc.reshape(nb, nn)
        total = runs(runs(zg, 32)[:, :, -1], nn // 32)[:, 0, -1]
    if sums is not None:
        sums.update(zg=zg, cc=cc, total=total, cum_zg=czg, cum_cc=ccc)
    cum_zg, cum_cc = czg[rows, k], ccc[rows, k]
    suffix = total[:, None] - cum_zg
    prefix = cum_cc - ccoef
    rate_p = ((cbf1 + lastb) + prefix) + (ccoef - sig1)
    cost = np.where(kept > 0, lam * rate_p + suffix, F32(np.inf)).astype(F32)
    by_scan = np.empty((nb, nn), F32)
    by_scan[rows, k] = cost
    best_k = by_scan.argmin(axis=1)     # the first minimum
    best = by_scan[np.arange(nb), best_k]
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
                got = rdoq_model(coeff.reshape(nb, -1).numpy(),
                                 levels.reshape(nb, -1).numpy(),
                                 modes.numpy(), n, qp, use_dst, rescale,
                                 scan, scale, sums)
                assert np.array_equal(got.reshape(nb, n, n), want.numpy()), \
                    (qp, scan, scale)
                # the serial runs give the plain version's sums bit for bit
                zg, cc = (torch.from_numpy(sums[x]) for x in ("zg", "cc"))
                for mine, plain in (
                        (sums["total"], ordered_sum(zg)),
                        (sums["cum_zg"], ordered_cumsum(zg)),
                        (sums["cum_cc"], ordered_cumsum(cc))):
                    assert mine.tobytes() == plain.numpy().tobytes()
                changed += int((want != levels).any(dim=(1, 2)).sum())
    assert changed > 0                  # RDOQ moved some blocks


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
