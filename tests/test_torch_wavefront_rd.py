"""A model of the RD closed loop's kernel (`csrc/wavefront_rd.cu` with
`csrc/rate_model.cuh`), held to the plain loop
(`models.wavefront._encode_planes_rd`) and to JAX's closed-loop scan
(`encode_planes_closed_loop(decision="rd")`) on the CPU before the card
runs it.  The tolerance is 0 everywhere.

The model follows the kernel's schedule, not the plain loop's: each
diagonal of every frame of the batch at once; phase A evaluates every
(frame, slot, candidate), reading its references from the skewed
buffers by the kernel's per-sample rule and keeping them for phase B;
each candidate's bin counts are one thread block's partial counts,
summed into the frame's count vector in a shuffled order; phase B
prices each frame's batches again from the counts, in the kernel's
float32 arithmetic (numpy, every transcendental in float64 rounded
once), sums each candidate's bits in the kernel's runs, adds lambda
times the MPM bits, decides, codes the chosen block and writes the
skewed buffers as the kernel writes them.  A model that leaves the
off-plane slots out of the counts must NOT match JAX: that shows the
trap is covered.  Then the wrapper: its refusals, and that a CPU tensor
reaches the plain loop.  The kernel itself runs on the card only
(chip_smoke.py's 3h and price sweep).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nanohevc_tpu.models.wavefront as jax_wf
from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels import wavefront as kwf
from nanohevc_tpu_torch.kernels import wavefront_rd as krd
from nanohevc_tpu_torch.models import wavefront as torch_wf
from nanohevc_tpu_torch.models.all_intra import _clip
from nanohevc_tpu_torch.ops import rate
from nanohevc_tpu_torch.ops.mode_rate import mpm_mode_bits

F32 = np.float32
LOG_GAMMA, LN2 = (F32(v) for v in krd.RATE_CONSTS)


def textured(h, w, seed, bit_depth=8):
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * (peak + 1) // max(h, 1) + xx * (peak + 1) // (2 * w)
            + (peak // 6) * np.sin(xx / 5.0 + yy / 9.0))
    noise = rng.integers(-peak // 20, peak // 20 + 1, (h, w))
    return np.clip(base + noise, 0, peak).astype(np.int32)


def smooth(h, w, seed, bit_depth=8):
    """A near-linear ramp with faint noise: flat enough at N=32 for the
    strong reference filter."""
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = 40 + (yy * 2 + xx) * (peak // 2) // (2 * h + w)
    return np.clip(base + rng.integers(0, 2, (h, w)), 0, peak).astype(np.int32)


# --- the rate model as the kernel computes it --------------------------------

def max_len(nn):
    return {16: 3, 64: 5, 256: 7, 1024: 9}[nn]


def row_counts(packed):
    """count_row: (rows, NN) diag-packed levels -> (rows, KC) int64, one
    thread block's counts a row, in adaptive_counts' layout."""
    a = np.abs(packed.astype(np.int64))
    rows, nn = a.shape
    m = max_len(nn)
    pos = np.arange(nn)
    sig = a > 0
    last = np.where(sig, pos, -1).max(axis=1)
    coded = last >= 0
    lastidx = np.where(coded, last, nn - 1)
    klen = sum((lastidx + 1 >= (1 << k)).astype(np.int64)
               for k in range(1, m + 1))
    full = coded & (lastidx == nn - 1)
    nf = coded & ~full
    emitted = coded[:, None] & (pos[None, :] < lastidx[:, None])
    ctx = np.eye(32, dtype=np.int64)[np.minimum(pos, 31)]      # (NN, 32)
    out = np.zeros((rows, 70 + 2 * m), np.int64)
    out[:, 0], out[:, 1], out[:, 2] = 1, coded, full
    for i in range(m):
        out[:, 3 + i] = nf & (klen > i)
        out[:, 3 + m + i] = nf & (klen >= i)
    out[:, 3 + 2 * m:35 + 2 * m] = (sig & emitted).astype(np.int64) @ ctx
    out[:, 35 + 2 * m:67 + 2 * m] = emitted.astype(np.int64) @ ctx
    out[:, 67 + 2 * m] = sig.sum(axis=1)
    out[:, 68 + 2 * m] = (a > 1).sum(axis=1)
    out[:, 69 + 2 * m] = (a > 2).sum(axis=1)
    return out


def atomic_sum(partials, rng):
    """The thread blocks' partial counts added into one vector in an
    order the schedule does not fix."""
    total = np.zeros(partials.shape[1:], np.int64)
    for k in rng.permutation(len(partials)):
        total += partials[k]
    return total


def ctx_prices(n1, n):
    """rate_model.cuh's ctx_prices over arrays of float32 counts."""
    def rounded(fn, x):
        return fn(np.asarray(x, np.float64)).astype(F32)

    p = (n1 + F32(0.5)) / (n + F32(1.0))
    l1, l0 = rounded(np.log2, p), rounded(np.log2, F32(1.0) - p)
    c1, c0 = -l1, -l0
    emp = n1 * c1 + (n - n1) * c0
    n0 = n - n1
    ts = rounded(np.log, np.maximum(p, F32(1e-6)) / F32(0.5)) / LOG_GAMMA
    ts = np.minimum(np.maximum(ts, F32(0.0)), n)
    pw = rounded(lambda t: 0.96875 ** t, ts)
    trans = ((F32(0.5) * (F32(1.0) - pw)) / F32(0.03125)) / LN2
    e1 = np.where(n1 > 0, n1 * l1, F32(0.0))
    e0 = np.where(n0 > 0, n0 * l0, F32(0.0))
    ent = -(e1 + e0) / np.maximum(n, F32(1.0))
    steady = np.maximum(n - ts, F32(0.0)) * ent
    total = np.where(n > 0, trans + steady, F32(0.0))
    scale = np.where(emp > 0, total / np.maximum(emp, F32(1e-9)), F32(1.0))
    return (c1 * scale).astype(F32), (c0 * scale).astype(F32)


def price_batch(counts, nn):
    """price_batch: (KC,) counts -> the prices of one batch."""
    m = max_len(nn)
    c = counts.astype(F32)
    idx1 = [1, 2] + [3 + i for i in range(m)] + \
        [3 + 2 * m + k for k in range(32)] + [68 + 2 * m, 69 + 2 * m]
    idx0 = [0, 1] + [3 + m + i for i in range(m)] + \
        [35 + 2 * m + k for k in range(32)] + [67 + 2 * m, 68 + 2 * m]
    p1, p0 = ctx_prices(c[idx1], c[idx0])
    cum1 = np.zeros(m + 1, F32)
    for i in range(m):                          # a sequential float32 scan
        cum1[i + 1] = cum1[i] + p1[2 + i]
    return dict(cbf1=p1[0], cbf0=p0[0], lf1=p1[1], lf0=p0[1],
                lp0=np.append(p0[2:2 + m], F32(0.0)), cum1=cum1,
                sig1=p1[2 + m:34 + m], sig0=p0[2 + m:34 + m],
                g11=p1[-2], g10=p0[-2], g21=p1[-1], g20=p0[-1])


def eg0_bits(a):
    x = np.maximum(a - 2, 1)
    e = np.floor(np.log2(x.astype(np.float64))).astype(np.int64)
    e = e - np.isin(x, (8192, 32768)) + np.isin(x, (2097151, 4194303))
    return F32(2.0) * e.astype(F32) + F32(1.0)


def row_bits(packed, last, P):
    """row_bits: (rows, NN) packed levels at one batch's prices ->
    (rows,) float32, the per-position costs summed in runs of 32 (16 at
    N=4) left to right, then the runs left to right."""
    a = np.abs(packed.astype(np.int64))
    rows, nn = a.shape
    m = max_len(nn)
    pos = np.arange(nn)
    ctx = np.minimum(pos, 31)
    coded = last >= 0
    lastidx = np.where(coded, last, nn - 1)
    emitted = coded[:, None] & (pos[None, :] < lastidx[:, None])
    cost_sig = np.where(emitted, np.where(a > 0, P["sig1"][ctx],
                                          P["sig0"][ctx]), F32(0.0))
    gt = np.where(a > 1, P["g11"] + np.where(a > 2, P["g21"] + eg0_bits(a),
                                             P["g20"]), P["g10"])
    per = (cost_sig + np.where(a > 0, gt + F32(1.0), F32(0.0))).astype(F32)
    run = min(32, nn)
    runs = per.reshape(rows, nn // run, run)
    acc = runs[:, :, 0]
    for i in range(1, run):
        acc = acc + runs[:, :, i]
    total = acc[:, 0]
    for r in range(1, nn // run):
        total = total + acc[:, r]
    klen = sum((lastidx + 1 >= (1 << k)).astype(np.int64)
               for k in range(1, m + 1))
    full = coded & (lastidx == nn - 1)
    prefix = P["cum1"][klen] + np.where(klen < m, P["lp0"][klen], F32(0.0))
    last_cost = np.where(full, P["lf1"],
                         (P["lf0"] + prefix) + klen.astype(F32))
    return np.where(coded, (P["cbf1"] + last_cost) + total, P["cbf0"])


# --- the kernel's schedule ---------------------------------------------------

def candidate_preds(refs, n, mode_set, smoothing, bit_depth):
    """rd_predict of every candidate: (slots, 4N+2) -> (slots, NC, N, N),
    candidate c predicting mode c (0 planar, 1 DC, 2..34 angular)."""
    routed = smoothing and n > 4
    refs_f = ops.smooth_refs(refs, n, bit_depth) if routed else refs
    preds = [ops.planar_predict(refs_f if routed else refs, n),
             ops.dc_predict(refs, n)]
    out = torch.stack(preds, dim=1)
    if mode_set == "all":
        refs_in = torch.cat([refs, refs_f], dim=1) if routed else refs
        out = torch.cat([out, ops.angular_predict_modes(
            refs_in, n, ops.ALL_ANGULAR, routed)], dim=1)
    return out


def kernel_model(planes, qp, n, *, mode_set="dc_planar", use_dst=False,
                 bit_depth=8, scan="diag", dequant_rescale=False,
                 intra_smoothing=False, rdoq=False, rd_lambda_scale=1.0,
                 count_off_plane=True, seed=0):
    """wavefront_rd.cu on (B, Hp, Wp) block-aligned int32 planes -> the
    dict of `_encode_planes_rd`."""
    rng = np.random.default_rng(seed)
    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    ndiag = nby + nbx - 1
    nn, r2 = n * n, 4 * n + 2
    nc = 35 if mode_set == "all" else 2
    wd = (ndiag + 2) * n + 2
    boundary = 1 << (bit_depth - 1)
    lam = F32(rate._rd_lambda(qp, 1.0))
    s_bot = np.zeros((b, nby, wd), np.int64)
    r_sp = np.zeros((b, ndiag + nby, wd), np.int64)
    prev = np.ones((b, nby), np.int64)
    recon = torch.zeros((b, hp, wp), dtype=torch.int32)
    levels = torch.zeros((b, nby * nbx, n, n), dtype=torch.int32)
    modes = torch.zeros((b, nby * nbx), dtype=torch.int32)
    src = planes.numpy()
    slot = np.arange(nby)
    for d in range(ndiag):
        # --- phase A: every (frame, slot, candidate) -------------------------
        bx = d - slot
        k = slot * ndiag + d                      # skewed_pixel
        rr, cc = k // (ndiag + 1), k % (ndiag + 1)
        blk = np.zeros((b, nby, n, n), np.int64)
        for s in range(nby):
            if cc[s] < nbx:
                blk[:, s] = src[:, rr[s] * n:rr[s] * n + n,
                                cc[s] * n:cc[s] * n + n]
        edge = (slot == 0) | (bx == 0)
        refs = np.full((b, nby, r2), boundary, np.int64)
        for s in range(nby):
            if s > 0:
                refs[:, s, :2 * n + 1] = s_bot[:, s - 1, d * n:d * n + 2 * n + 1]
            if bx[s] != 0:
                refs[:, s, 2 * n + 1:] = r_sp[:, d + nby - 1 - s,
                                              d * n:d * n + 2 * n + 1]
            if edge[s]:
                refs[:, s, 0] = refs[:, s, 2 * n + 1] = boundary
        refs_t = torch.from_numpy(refs.reshape(b * nby, r2)).to(torch.int32)
        blk_t = torch.from_numpy(blk.reshape(b * nby, n, n)).to(torch.int32)
        preds = candidate_preds(refs_t, n, mode_set, intra_smoothing,
                                bit_depth)
        x = blk_t[:, None].expand(preds.shape).reshape(-1, n, n)
        pr = preds.reshape(-1, n, n)
        lev = ops.quantize(ops.forward_transform(x - pr, use_dst), qp, n, True)
        rec = _clip(pr + ops.inverse_transform(
            ops.dequantize(lev, qp, n, rescale=dequant_rescale), use_dst),
            bit_depth)
        diff = (x - rec).to(torch.int64)
        sse = (diff * diff).sum(dim=(1, 2)).to(torch.float32).numpy()
        packed = ops.scan_pack(lev, "diag").numpy()
        last = np.where(packed != 0, np.arange(nn), -1).max(axis=1)
        partial = row_counts(packed).reshape(b, nby, nc, -1)
        counted = np.ones(nby, bool) if count_off_plane else \
            (bx >= 0) & (bx < nbx)
        counts = [[atomic_sum(partial[f][counted][:, cs].reshape(
            -1, partial.shape[-1]), rng) for cs in (slice(0, 2),
                                                     slice(2, nc))]
                  for f in range(b)]
        # --- phase B: each (frame, slot) prices, decides and codes -------------
        costs = np.zeros((b * nby, nc), F32)
        sse = sse.reshape(b * nby, nc)
        packed = packed.reshape(b * nby, nc, nn)
        last = last.reshape(b * nby, nc)
        for f in range(b):
            prices = [price_batch(counts[f][0], nn)]
            if nc == 35:
                prices.append(price_batch(counts[f][1], nn))
            rows = slice(f * nby, (f + 1) * nby)
            for c in range(nc):
                bits = row_bits(packed[rows, c], last[rows, c],
                                prices[c >= 2])
                costs[rows, c] = sse[rows, c] + lam * bits
        am = np.where(slot == d, 1, prev)
        bm = np.concatenate([np.ones((b, 1), np.int64), prev[:, :-1]], axis=1)
        mb = mpm_mode_bits(torch.from_numpy(am.reshape(-1)),
                           torch.from_numpy(bm.reshape(-1))).numpy()
        costs = costs + lam * mb[:, :nc]
        if nc == 2:
            mode = np.where(costs[:, 1] <= costs[:, 0], 1, 0)
        else:
            mode = costs.argmin(axis=1)
        prev = mode.reshape(b, nby)
        mode_t = torch.from_numpy(mode).to(torch.int32)
        pred = preds[torch.arange(b * nby), mode_t.long()]
        lv, rc = kwf.code_residual(
            blk_t, pred, qp, n, use_dst=use_dst, bit_depth=bit_depth,
            dequant_rescale=dequant_rescale, rdoq=rdoq, scan=scan,
            modes=mode_t, rd_lambda_scale=rd_lambda_scale)
        lv, rc = lv.reshape(b, nby, n, n), rc.reshape(b, nby, n, n)
        c0 = d * n + n + 1
        for s in range(nby):
            if not 0 <= bx[s] < nbx:
                continue                          # off the plane: mode only
            recon[:, s * n:s * n + n, bx[s] * n:bx[s] * n + n] = rc[:, s]
            levels[:, s * nbx + bx[s]] = lv[:, s]
            modes[:, s * nbx + bx[s]] = mode_t.reshape(b, nby)[:, s]
            r = rc[:, s].numpy()
            s_bot[:, s, c0:c0 + n] = r[:, n - 1, :]
            r_sp[:, d + nby - s, c0:c0 + n] = r[:, :, n - 1]
            if bx[s] == nbx - 1:
                s_bot[:, s, c0 + n:c0 + 2 * n] = r[:, n - 1, n - 1:n]
            if s == nby - 1:
                r_sp[:, d + nby - s, c0 + n:c0 + 2 * n] = r[:, n - 1, n - 1:n]
    return {"recon": recon, "levels": levels, "modes": modes}


def plain(planes, qp, n, **kw):
    args = dict(mode_set="dc_planar", use_dst=False, bit_depth=8,
                scan="diag", dequant_rescale=False, intra_smoothing=False,
                rdoq=False, rd_lambda_scale=1.0)
    args.update(kw)
    return torch_wf._encode_planes_rd(planes, qp, n, **args)


def padded(p, n):
    return torch_wf.pad_to_blocks(torch.from_numpy(p), n)


# (name, N, crop, QP, batch, plane maker, keywords)
CASES = [
    ("n4_dst_45x200", 4, (45, 200), 27, 1, textured, dict(use_dst=True)),
    ("n8_45x200_batch2", 8, (45, 200), 22, 2, textured, {}),
    ("n16_all_smoothing", 16, (45, 200), 30, 1, textured,
     dict(mode_set="all", intra_smoothing=True)),
    ("n32_all_strong_filter", 32, (70, 200), 22, 1, smooth,
     dict(mode_set="all", intra_smoothing=True)),
    ("n8_rdoq_mode_scan_scale3", 8, (45, 200), 22, 1, textured,
     dict(rdoq=True, scan="mode", rd_lambda_scale=3.0)),
    ("n8_all_10bit_rescale", 8, (45, 72), 37, 2, textured,
     dict(mode_set="all", bit_depth=10, dequant_rescale=True)),
]


def case_planes(name):
    _, n, (h, w), qp, b, make, kw = next(c for c in CASES if c[0] == name)
    bd = kw.get("bit_depth", 8)
    p = np.stack([make(h, w, 7 * n + qp + f, bd) for f in range(b)])
    return p, padded(p, n), n, qp, kw


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_kernel_model_matches_the_plain_loop(name):
    _, x, n, qp, kw = case_planes(name)
    got = kernel_model(x, qp, n, seed=len(name), **kw)
    want = plain(x, qp, n, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_the_strong_filter_is_taken():
    """The N=32 case's references are flat enough for the 32x32 strong
    filter on some block, so the model meets it."""
    _, x, n, qp, _ = case_planes("n32_all_strong_filter")
    refs = ops.extract_refs(x[0], n)
    top, left = refs[:, :2 * n + 1], refs[:, 2 * n + 1:]
    corner = top[:, :1]
    flat = ((corner + top[:, 2 * n:] - 2 * top[:, n:n + 1]).abs() < 8) & \
        ((corner + left[:, 2 * n:] - 2 * left[:, n:n + 1]).abs() < 8)
    assert bool(flat.any())


JAX_CASES = ("n8_45x200_batch2", "n4_dst_45x200")


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's closed loop under decision="rd" on two of the crops."""
    out = {}
    for name in JAX_CASES:
        p, _, n, qp, kw = case_planes(name)
        res = jax.jit(lambda a, q: jax_wf.encode_planes_closed_loop(
            a, q, n=n, decision="rd", **kw))(jnp.asarray(p), jnp.int32(qp))
        out[name] = {k: np.asarray(v) for k, v in res.items()}
    return out


def closed_loop_levels(got, n, h, w):
    """The model's raster dict in encode_planes_closed_loop's form."""
    b, nb = got["modes"].shape
    lv = ops.scan_pack(got["levels"].reshape(b * nb, n, n), "diag")
    return {"recon": got["recon"][:, :h, :w].numpy(),
            "levels": lv.reshape(b, nb, n * n).numpy(),
            "modes": got["modes"].numpy()}


@pytest.mark.parametrize("name", JAX_CASES)
def test_kernel_model_matches_jax(name, jax_outputs):
    p, x, n, qp, kw = case_planes(name)
    got = closed_loop_levels(kernel_model(x, qp, n, **kw), n, *p.shape[1:])
    for k in ("recon", "levels", "modes"):
        assert np.array_equal(got[k], jax_outputs[name][k]), k


def test_off_plane_slots_must_be_counted(jax_outputs):
    """Leaving the off-plane slots out of the counts changes the bits:
    such a model does not match JAX, so the cases above cover the trap."""
    name = "n4_dst_45x200"
    p, x, n, qp, kw = case_planes(name)
    got = closed_loop_levels(
        kernel_model(x, qp, n, count_off_plane=False, **kw), n, *p.shape[1:])
    assert not all(np.array_equal(got[k], jax_outputs[name][k])
                   for k in ("recon", "levels", "modes"))


@pytest.mark.parametrize("seed", [0, 1])
def test_model_prices_are_the_hosts(seed):
    """ctx_prices, as the kernel computes each context, equals the
    host's `ops.rate._prices` bit for bit (the device's float64
    transcendentals are held to it on the card by chip_smoke's sweep)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 1 << 21, 20000)
    n[:64] = np.arange(64)
    n1 = (rng.random(n.size) * (n + 1)).astype(np.int64).clip(0, n)
    got = ctx_prices(n1.astype(F32), n.astype(F32))
    want = rate._prices(n1.astype(F32), n.astype(F32))
    for g, w_ in zip(got, want):
        assert np.array_equal(g.view(np.int32), w_.view(np.int32))


def test_model_counts_and_bits_are_the_hosts():
    """row_counts summed == adaptive_counts, and row_bits ==
    adaptive_bits at the model's prices, on rows with empty, full and
    escape-coded levels at every N."""
    rng = np.random.default_rng(3)
    for nn in (16, 64, 256, 1024):
        rows = rng.integers(-4, 5, (40, nn)) * (rng.random((40, nn)) < 0.3)
        rows[0] = 0
        rows[1, -1] = 9
        rows[2, :] = 40000
        counts = row_counts(rows).sum(axis=0)
        t = torch.from_numpy(rows.astype(np.int32))
        assert np.array_equal(counts, rate.adaptive_counts(t).numpy())
        P = price_batch(counts, nn)
        host = rate.adaptive_prices(torch.from_numpy(counts), nn)
        for k in ("cum1", "lp0", "sig1", "sig0"):
            assert np.array_equal(P[k], host[k].numpy()), k
        last = np.where(rows != 0, np.arange(nn), -1).max(axis=1)
        assert np.array_equal(row_bits(rows, last, P),
                              rate.adaptive_bits(t, host).numpy())


# --- satellite routes and the wrapper ------------------------------------------

@pytest.mark.parametrize("mode_set", ["dc", "planar"])
def test_fixed_mode_sets_under_rd_run_the_wavefront_route(mode_set,
                                                          monkeypatch):
    """decision="rd" with a fixed mode set takes no cost, so it goes to
    the wavefront kernel's fixed body (on the CPU its plain loop), not
    to the RD loop, and gives JAX's bits."""
    p = np.stack([textured(37, 53, 5 + f) for f in range(2)])
    entries = {"rd": 0, "wavefront": 0}

    def counted(key, fn):
        def call(*a, **k):
            entries[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(torch_wf, "_encode_planes_rd",
                        counted("rd", torch_wf._encode_planes_rd))
    monkeypatch.setattr(kwf, "wavefront_encode_planes_reference",
                        counted("wavefront",
                                kwf.wavefront_encode_planes_reference))
    kw = dict(n=4, mode_set=mode_set, decision="rd", rdoq=True)
    got = torch_wf.encode_planes_closed_loop(torch.from_numpy(p), 27, **kw)
    assert entries == {"rd": 0, "wavefront": 1}
    want = jax.jit(lambda a, q: jax_wf.encode_planes_closed_loop(
        a, q, **kw))(jnp.asarray(p), jnp.int32(27))
    for k in ("recon", "levels", "modes"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert kwf.wavefront_covers(4, mode_set, "rd", False)
    assert not kwf.wavefront_covers(4, "dc_planar", "rd", False)
    assert not kwf.wavefront_supported(4, mode_set, "rd", False)


@pytest.mark.parametrize("bad", ["dtype", "dims", "aligned", "contiguous",
                                 "mode_set", "dst", "n", "scan"])
def test_wrapper_refuses(bad):
    planes = torch.from_numpy(textured(16, 24, 2)[None])
    kw = dict(mode_set="dc_planar")
    n = 8
    if bad == "dtype":
        planes = planes.to(torch.int64)
    elif bad == "dims":
        planes = planes[0]
    elif bad == "aligned":
        planes = planes[:, :12]
    elif bad == "contiguous":
        planes = planes.transpose(1, 2)
    elif bad == "mode_set":
        kw["mode_set"] = "dc"
    elif bad == "dst":
        kw["use_dst"] = True
    elif bad == "n":
        n = 5
    else:
        kw["scan"] = "zigzag"
    with pytest.raises((ValueError, TypeError)):
        krd.wavefront_rd_encode_planes(planes.contiguous() if bad != "contiguous"
                                       else planes, 22, n, **kw)


@pytest.mark.parametrize("kw", [dict(mode_set="dc_planar"),
                                dict(mode_set="all", intra_smoothing=True,
                                     rdoq=True, scan="vertical")])
def test_wrapper_on_cpu_is_the_plain_loop(kw, monkeypatch):
    planes = torch.from_numpy(np.stack([textured(24, 32, 6 + f)
                                        for f in range(2)]))
    calls = []
    real = torch_wf._encode_planes_rd

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch_wf, "_encode_planes_rd", counted)
    before = krd.wavefront_rd_encode_planes.launches
    got = krd.wavefront_rd_encode_planes(planes, 25, 8, **kw)
    assert calls == [1]
    assert krd.wavefront_rd_encode_planes.launches == before
    want = real(planes, 25, 8, **dict(
        dict(use_dst=False, bit_depth=8, scan="diag", dequant_rescale=False,
             intra_smoothing=False, rdoq=False, rd_lambda_scale=1.0), **kw))
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine chip_smoke.py "
                    "phase 3h runs this check")
    _, x, n, qp, kw = case_planes(name)
    got = krd.wavefront_rd_encode_planes(x.cuda(), qp, n, **kw)
    want = plain(x.cuda(), qp, n, **kw)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k
