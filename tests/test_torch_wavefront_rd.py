"""A model of the RD closed loop's kernel (`csrc/wavefront_rd.cu` with
`csrc/rate_model.cuh`), held to the plain loop
(`kernels.wavefront_rd.wavefront_rd_encode_planes_reference`) and to
JAX's closed-loop scan (`encode_planes_closed_loop(decision="rd")`) on
the CPU before the card runs it.  The tolerance is 0 everywhere.

The model follows the kernel's schedule, not the plain loop's: its
thread blocks are generators, each owning a run of consecutive slots of
a frame (and coding frames in turns where the grid holds fewer than the
batch) and waiting only where the kernel waits (the ready word of the
block above before A(d), the frame's arrival counter before B(d)); a
scheduler interleaves them in a seeded random order or in the orders
that run the lowest or the highest block first.  Phase A reads each
slot's references from the skewed buffers by the kernel's per-sample
rule, evaluates every candidate and adds its bins into the frame's count
vector of that diagonal; phase B prices the counts in the kernel's
float32 arithmetic (numpy, every transcendental in float64 rounded
once), sums each candidate's bits from its level codes in the kernel's
runs, adds lambda times the MPM bits (the mode above from the ready
word), decides, codes the chosen blocks and writes the skewed buffers as
the kernel writes them.  Faults the tests show the plain loop catches:
a model that leaves the off-plane slots out of the counts does not
match JAX; one that reads the ready word without waiting on it, or runs
B(d) (and writes s_bot) before the frame's reduction of d, does not
match the plain loop.  Then the wrapper: its refusals, and that a CPU
tensor reaches the plain loop.  The kernel itself runs on the card only
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
from nanohevc_tpu_torch.ops.mode_decision import _clip
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


def level_code(a):
    """rate_model.cuh's level_code: 0, 1, 2, or 3 + EG0's exponent."""
    a = np.asarray(a, np.int64)
    x = np.maximum(a - 2, 1)
    e = np.floor(np.log2(x.astype(np.float64))).astype(np.int64)
    e = e - np.isin(x, (8192, 32768)) + np.isin(x, (2097151, 4194303))
    return np.where(a <= 2, a, 3 + e)


def code_bits(codes, last, P):
    """group_bits: the bits of (rows, NN) level_code bytes at one batch's
    prices, each position priced from its code (a > 2 through
    2 (code - 3) + 1), summed as row_bits sums."""
    a_eq = np.where(codes <= 2, codes, 3)      # 0, 1, 2 or "> 2"
    eg0 = F32(2.0) * (codes - 3).astype(F32) + F32(1.0)
    rows, nn = codes.shape
    m = max_len(nn)
    pos = np.arange(nn)
    ctx = np.minimum(pos, 31)
    coded = last >= 0
    lastidx = np.where(coded, last, nn - 1)
    emitted = coded[:, None] & (pos[None, :] < lastidx[:, None])
    cost_sig = np.where(emitted, np.where(a_eq > 0, P["sig1"][ctx],
                                          P["sig0"][ctx]), F32(0.0))
    gt = np.where(a_eq > 1, P["g11"] + np.where(a_eq > 2, P["g21"] + eg0,
                                                P["g20"]), P["g10"])
    per = (cost_sig + np.where(a_eq > 0, gt + F32(1.0), F32(0.0))).astype(F32)
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


def preferred_slots(mode_set, n):
    """Slots a thread block by preference (Rd::WPREF of the kernel that
    can code a block one thread a pixel): the 35 modes 2 at N = 4, else
    1; the pair 4, 1 at N = 32."""
    if mode_set == "all":
        return 2 if n == 4 else 1
    return 1 if n == 32 else 4


def next_state(win, lastpix_prev, rowb, colr, d, s0, n, nby, nbx,
               boundary):
    """A thread block's next_refs after B(d) (d = -1: the start): each
    slot's window W(d + 1) of s_bot, its last pixel at d, and the
    references of d + 1 (the first slot's top arm and corner left as 0:
    the message's), from W(d), the last pixels at d - 1 and the slots'
    bottom rows and right columns at d."""
    nw = win.shape[0]
    r = 2 * n + 1
    slot = s0 + np.arange(nw)
    bx = d - slot
    on = (bx >= 0) & (bx < nbx)
    new = np.zeros_like(win)
    new[:, 0] = win[:, n]
    new[:, 1:n + 1] = np.where(on[:, None], rowb, win[:, n + 1:])
    new[:, n + 1:] = np.where((on & (bx == nbx - 1))[:, None],
                              rowb[:, n - 1:n], 0)
    lastpix = np.where(on, rowb[:, n - 1], 0)
    refs = np.zeros((nw, 2 * r), np.int64)
    bxn = d + 1 - slot
    for w in range(nw):
        edge = slot[w] == 0 or bxn[w] == 0
        if slot[w] == 0:
            refs[w, :r] = boundary
        elif w > 0:
            refs[w, :r] = new[w - 1]
        if edge:
            refs[w, 0] = boundary
        if bxn[w] == 0:
            refs[w, r:] = boundary
            continue
        refs[w, r] = lastpix_prev[w - 1] if w > 0 else 0
        refs[w, r + 1:r + n + 1] = colr[w] if on[w] else 0
        refs[w, r + n + 1:] = rowb[w, n - 1] if on[w] and \
            slot[w] == nby - 1 else 0
        if edge:
            refs[w, r] = boundary
    return new, lastpix, refs


def kernel_model(planes, qp, n, *, mode_set="dc_planar", use_dst=False,
                 bit_depth=8, scan="diag", dequant_rescale=False,
                 intra_smoothing=False, rdoq=False, rd_lambda_scale=1.0,
                 count_off_plane=True, slots=None, frames=None,
                 order="random", check_tags=True, wait_frame=True, seed=0):
    """wavefront_rd.cu on (B, Hp, Wp) block-aligned int32 planes -> the
    dict of `wavefront_rd_encode_planes_reference`.

    The kernel's thread blocks are generators, one a run of `slots`
    consecutive slots of a frame, the grid holding `frames` frames'
    blocks (default: the batch) and each block coding frames f0, f0 +
    frames, ... in turn, each yielding the condition it waits on: for A(d),
    the message of the block above tagged d (the last slot's s_bot window,
    its last pixel at d - 2 and its mode at d - 1); for B(d), every thread
    block of the frame having added its bins to the counters of d.  A block
    keeps each slot's window and last pixels itself and builds the next
    diagonal's references from them (next_state), as the kernel does in
    shared memory; only the first slot's top arm and corner cross blocks.  A
    scheduler resumes one block whose condition holds, chosen by `order`:
    "random" (seeded), "below_first" (the lowest block in the plane) or
    "above_first" (the highest).  check_tags=False reads the message without
    waiting for its tag; wait_frame=False lets B(d) run (price, decide, send
    its message) before the frame's counters of d are complete: faults the
    tests show the plain loop catches."""
    rng = np.random.default_rng(seed)
    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    ndiag = nby + nbx - 1
    nn, r = n * n, 2 * n + 1
    nc = 35 if mode_set == "all" else 2
    nb = 2 if nc == 35 else 1
    kc = 70 + 2 * max_len(nn)
    slots = slots or preferred_slots(mode_set, n)
    groups = -(-nby // slots)
    boundary = 1 << (bit_depth - 1)
    lam = F32(rate._rd_lambda(qp, 1.0))
    messages = [[None] * nby for _ in range(b)]   # (tag, words) at last slot
    counts = np.zeros((b, ndiag, nb, kc), np.int64)
    arrivals = np.zeros((b, ndiag), np.int64)
    recon = torch.zeros((b, hp, wp), dtype=torch.int32)
    levels = torch.zeros((b, nby * nbx, n, n), dtype=torch.int32)
    modes = torch.zeros((b, nby * nbx), dtype=torch.int32)
    src = planes.numpy()

    def block(f0, s0):
        for f in range(f0, b, frames):
            yield from frame_block(f, s0)

    def frame_block(f, s0):
        nw = min(slots, nby - s0)
        slot = np.arange(s0, s0 + nw)
        last_slot = s0 + nw - 1
        win = np.zeros((nw, r), np.int64)
        lastpix = np.zeros(nw, np.int64)          # at d - 1
        zeros = np.zeros((nw, n), np.int64)
        win, lastpix_d, refs = next_state(win, lastpix, zeros, zeros, -1, s0,
                                          n, nby, nbx, boundary)
        lastpix_prev, lastpix = lastpix, lastpix_d
        prev = np.ones(nw, np.int64)              # before diagonal 0: DC
        for d in range(ndiag):
            # --- A(d): the message of the block above --------------------
            above = 1
            bx = d - slot
            if s0 > 0 and d > 0:
                if check_tags:
                    # (in the kernel's schedule the tag is never newer
                    # than d; only a faulty one runs a block that far)
                    yield lambda: messages[f][s0 - 1] is not None and \
                        messages[f][s0 - 1][0] >= d
                m = messages[f][s0 - 1]
                words = m[1] if m is not None else [0] * (2 * n + 3)
                top = np.array(words[:r], np.int64)
                if bx[0] == 0:
                    top[0] = refs[0, 0]           # the edge's boundary
                refs[0, :r] = top
                if bx[0] != 0:
                    refs[0, r] = words[2 * n + 1]
                above = words[2 * n + 2]
            k = slot * ndiag + d                  # skewed_pixel
            rr, cc = k // (ndiag + 1), k % (ndiag + 1)
            blk = np.zeros((nw, n, n), np.int64)
            for w in range(nw):
                if cc[w] < nbx:
                    blk[w] = src[f, rr[w] * n:rr[w] * n + n,
                                 cc[w] * n:cc[w] * n + n]
            refs_t = torch.from_numpy(refs.copy()).to(torch.int32)
            blk_t = torch.from_numpy(blk).to(torch.int32)
            preds = candidate_preds(refs_t, n, mode_set, intra_smoothing,
                                    bit_depth)
            x = blk_t[:, None].expand(preds.shape).reshape(-1, n, n)
            pr = preds.reshape(-1, n, n)
            lev = ops.quantize(ops.forward_transform(x - pr, use_dst), qp, n,
                               True)
            rec = _clip(pr + ops.inverse_transform(
                ops.dequantize(lev, qp, n, rescale=dequant_rescale), use_dst),
                bit_depth)
            diff = (x - rec).to(torch.int64)
            sse = (diff * diff).sum(dim=(1, 2)).to(torch.float32).numpy()
            packed = ops.scan_pack(lev, "diag").numpy()
            last = np.where(packed != 0, np.arange(nn), -1).max(axis=1)
            codes = level_code(np.abs(packed))
            partial = row_counts(packed).reshape(nw, nc, kc)
            counted = np.ones(nw, bool) if count_off_plane else \
                (bx >= 0) & (bx < nbx)
            for bb, cs in enumerate((slice(0, 2), slice(2, nc))[:nb]):
                counts[f, d, bb] += atomic_sum(
                    partial[counted][:, cs].reshape(-1, kc), rng)
            arrivals[f, d] += 1
            if wait_frame:
                yield lambda: arrivals[f, d] == groups
            # --- B(d) -------------------------------------------------------
            prices = [price_batch(counts[f, d, bb], nn) for bb in range(nb)]
            sse, last = sse.reshape(nw, nc), last.reshape(nw, nc)
            codes = codes.reshape(nw, nc, nn)
            costs = np.zeros((nw, nc), F32)
            for c in range(nc):
                bits = code_bits(codes[:, c], last[:, c], prices[c >= 2])
                costs[:, c] = sse[:, c] + lam * bits
            am = np.where(slot == d, 1, prev)
            bm = np.where(slot == 0, 1, np.concatenate([[above], prev[:-1]]))
            mb = mpm_mode_bits(torch.from_numpy(am),
                               torch.from_numpy(bm)).numpy()
            costs = costs + lam * mb[:, :nc]
            if nc == 2:
                mode = np.where(costs[:, 1] <= costs[:, 0], 1, 0)
            else:
                mode = costs.argmin(axis=1)
            mode_t = torch.from_numpy(mode).to(torch.int32)
            pred = preds[torch.arange(nw), mode_t.long()]
            lv, rc = kwf.code_residual(
                blk_t, pred, qp, n, use_dst=use_dst, bit_depth=bit_depth,
                dequant_rescale=dequant_rescale, rdoq=rdoq, scan=scan,
                modes=mode_t, rd_lambda_scale=rd_lambda_scale)
            rc_np = rc.numpy().astype(np.int64)
            for w in range(nw):
                s, bxs = slot[w], bx[w]
                if not 0 <= bxs < nbx:
                    continue                      # off the plane: mode only
                recon[f, s * n:s * n + n, bxs * n:bxs * n + n] = rc[w]
                levels[f, s * nbx + bxs] = lv[w]
                modes[f, s * nbx + bxs] = int(mode[w])
            # next_refs(d): the windows, the references of d + 1, and the
            # message for the block below, tagged d + 1
            new_win, lastpix_d, refs = next_state(
                win, lastpix, rc_np[:, n - 1, :], rc_np[:, :, n - 1], d, s0,
                n, nby, nbx, boundary)
            if last_slot + 1 < nby:
                messages[f][last_slot] = (d + 1, list(new_win[-1]) +
                                          [int(lastpix[-1]), int(mode[-1])])
            win, lastpix = new_win, lastpix_d
            prev = mode.astype(np.int64)
            yield lambda: True

    frames = frames or b
    starts = [(f0, s0) for f0 in range(min(b, frames))
              for s0 in range(0, nby, slots)]
    gens = [block(f, s0) for f, s0 in starts]
    waits = [None] * len(gens)
    live = list(range(len(gens)))
    while live:
        ready = [k for k in live if waits[k] is None or waits[k]()]
        if not ready:
            raise RuntimeError("the model's schedule deadlocked")
        if order == "random":
            k = ready[rng.integers(len(ready))]
        elif order == "below_first":
            k = max(ready, key=lambda k: starts[k][1])
        else:
            k = min(ready, key=lambda k: starts[k][1])
        try:
            waits[k] = next(gens[k])
        except StopIteration:
            live.remove(k)
    return {"recon": recon, "levels": levels, "modes": modes}


def plain(planes, qp, n, **kw):
    args = dict(mode_set="dc_planar", use_dst=False, bit_depth=8,
                scan="diag", dequant_rescale=False, intra_smoothing=False,
                rdoq=False, rd_lambda_scale=1.0)
    args.update(kw)
    return krd.wavefront_rd_encode_planes_reference(planes, qp, n, **args)


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


@pytest.fixture(scope="module")
def plain_outputs():
    """The plain loop on each case, once a module."""
    cache = {}

    def get(name):
        if name not in cache:
            _, x, n, qp, kw = case_planes(name)
            cache[name] = plain(x, qp, n, **kw)
        return cache[name]
    return get


def same_outputs(got, want):
    return all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_kernel_model_matches_the_plain_loop(name, plain_outputs):
    _, x, n, qp, kw = case_planes(name)
    got = kernel_model(x, qp, n, seed=len(name), **kw)
    want = plain_outputs(name)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# (case, order, slots a thread block): the two extreme orders and random
# ones, one slot a block, the preferred 4 and a ragged last block
SCHEDULES = [
    ("n8_45x200_batch2", "below_first", 1),
    ("n8_45x200_batch2", "above_first", 4),
    ("n8_45x200_batch2", "random", 4),
    ("n8_45x200_batch2", "random", 5),
    ("n4_dst_45x200", "below_first", 3),
    ("n8_all_10bit_rescale", "above_first", 1),
    ("n8_all_10bit_rescale", "random", 2),
    ("n8_rdoq_mode_scan_scale3", "below_first", 2),
]


@pytest.mark.parametrize("name,order,slots", SCHEDULES)
def test_kernel_model_is_the_plain_loop_in_every_order(name, order, slots,
                                                       plain_outputs):
    """Whatever the order of the thread blocks and the slots a block
    owns, the waits of the schedule give the plain loop's outputs."""
    _, x, n, qp, kw = case_planes(name)
    got = kernel_model(x, qp, n, order=order, slots=slots, seed=slots, **kw)
    assert same_outputs(got, plain_outputs(name))


# (case, order, slots a thread block, frames in the grid): a batch larger
# than the grid, its frames coded in turns by the same thread blocks
STRIDES = [
    ("n8_45x200_batch2", "random", 4, 1),
    ("n8_45x200_batch2", "below_first", 2, 1),
    ("n8_all_10bit_rescale", "above_first", 1, 1),
]


@pytest.mark.parametrize("name,order,slots,frames", STRIDES)
def test_kernel_model_codes_a_batch_in_turns(name, order, slots, frames,
                                             plain_outputs):
    """A grid that holds fewer frames than the batch, each thread block
    coding its frames one after another, gives the plain loop's
    outputs."""
    _, x, n, qp, kw = case_planes(name)
    got = kernel_model(x, qp, n, order=order, slots=slots, frames=frames,
                       seed=slots, **kw)
    assert same_outputs(got, plain_outputs(name))


@pytest.mark.parametrize("fault,order,name", [
    ("check_tags", "below_first", "n8_45x200_batch2"),
    ("wait_frame", "above_first", "n8_all_10bit_rescale")])
def test_a_schedule_without_its_waits_differs(fault, order, name,
                                              plain_outputs):
    """A block that reads the ready word above without waiting on it, or
    that runs B(d) and writes s_bot before the frame's reduction of d,
    gives other outputs: the plain loop catches both faults.  (The
    second needs the angular modes: DC and planar never read the
    top-right samples that the early write replaces.)"""
    _, x, n, qp, kw = case_planes(name)
    got = kernel_model(x, qp, n, order=order, slots=1, **{fault: False},
                       **kw)
    assert not same_outputs(got, plain_outputs(name))


def test_level_codes_give_the_bits_of_the_levels():
    """A level's code (rate_model.cuh's level_code: 0, 1, 2 or 3 + EG0's
    exponent, XLA's deviations included) prices as the level does."""
    a = np.concatenate([np.arange(0, 70), [8193, 8194, 8195, 32769, 32770,
                                           2097152, 2097153, 4194304,
                                           4194305, 2 ** 30]])
    codes = level_code(a)
    assert codes.max() < 256
    got = F32(2.0) * (codes[a > 2] - 3).astype(F32) + F32(1.0)
    assert np.array_equal(got, eg0_bits(a[a > 2]))
    rng = np.random.default_rng(4)
    for nn in (16, 64, 256, 1024):
        rows = rng.integers(-40, 41, (12, nn)) * (rng.random((12, nn)) < 0.4)
        rows[0] = 0
        rows[1, 5] = 8194
        last = np.where(rows != 0, np.arange(nn), -1).max(axis=1)
        P = price_batch(row_counts(rows).sum(axis=0), nn)
        assert np.array_equal(code_bits(level_code(np.abs(rows)), last, P),
                              row_bits(rows, last, P))


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


def warp_bins(rows, batches, nb):
    """rate_model.cuh's count_candidates and store_bins on (rows, NN)
    diag-packed levels, each row a candidate of batch batches[r]: the
    bins gathered from bit masks (sig contexts 0..30 emitted and
    significant, the last position's prefix bins) and the scalars ->
    (nb, KC) counters."""
    nn = rows.shape[1]
    m = max_len(nn)
    kc = 70 + 2 * m
    k_pref1, k_pref0, k_one, k_tot = 3, 3 + m, 3 + 2 * m, 35 + 2 * m
    out = np.zeros((nb, kc), np.int64)
    for row, b in zip(np.abs(rows.astype(np.int64)), batches):
        sig = row > 0
        last = int(np.flatnonzero(sig).max()) if sig.any() else -1
        coded = last >= 0
        li = last if coded else nn - 1
        klen = sum(li + 1 >= (1 << k) for k in range(1, m + 1))
        full = coded and li == nn - 1
        nf = coded and not full
        em = 0 if not coded else 0x7fffffff if li >= 31 else (1 << li) - 1
        sig31 = sum(1 << k for k in range(min(31, nn)) if sig[k])
        one = em & sig31
        pm = ((1 << klen) - 1) | (((2 << klen) - 1) << 16) if nf else 0
        nsig = int(sig.sum())
        for k in range(31):
            out[b, k_tot + k] += (em >> k) & 1
            out[b, k_one + k] += (one >> k) & 1
        for i in range(m):
            out[b, k_pref1 + i] += (pm >> i) & 1
            out[b, k_pref0 + i] += (pm >> (16 + i)) & 1
        if coded:
            out[b, k_tot + 31] += max(li - 31, 0)
            out[b, k_one + 31] += nsig - bin(sig31).count("1") - (li >= 31)
        out[b, 67 + 2 * m] += nsig
        out[b, 68 + 2 * m] += int((row > 1).sum())
        out[b, 69 + 2 * m] += int((row > 2).sum())
        out[b, 0] += 1
        out[b, 1] += coded
        out[b, 2] += full
    return out


def test_warp_bins_are_the_hosts_counts():
    """The kernel's mask counting equals adaptive_counts, batch by
    batch, on rows with empty and full blocks, the last position at and
    around 31, and escape-coded levels, at every N."""
    rng = np.random.default_rng(8)
    for nn in (16, 64, 256, 1024):
        rows = rng.integers(-5, 6, (48, nn)) * (rng.random((48, nn)) < 0.3)
        rows[0] = 0
        rows[1, -1] = 3
        rows[2, :] = 70000
        for r, last in ((3, 30), (4, 31), (5, 32)):
            if last < nn:
                rows[r, last + 1:] = 0
                rows[r, last] = -2
        batches = rng.integers(0, 2, 48)
        got = warp_bins(rows, batches, 2)
        for b in (0, 1):
            t = torch.from_numpy(rows[batches == b].astype(np.int32))
            assert np.array_equal(got[b], rate.adaptive_counts(t).numpy())


# rate_model.cuh's pow_31_32: log2(31/32) as kHi + kLo
POW_HI, POW_LO = -0.04580368961312479, -2.5450972276520026e-18


def test_pow_31_32_formula_rounds_as_pow():
    """The device's 0.96875^t, exp2 of t * log2(31/32) kept in
    double-double (an exact FMA for the product's error) and exp2(hi)
    corrected by lo * ln 2, rounds to the float32 that numpy's pow
    rounds to, over seeded float32 t up to the clip's reach; its
    constants are the source's and split log2(31/32) exactly."""
    from decimal import Decimal, getcontext
    from fractions import Fraction
    from pathlib import Path

    src = (Path(krd.__file__).resolve().parent.parent / "csrc" /
           "rate_model.cuh").read_text()
    assert repr(POW_HI) in src and repr(POW_LO) in src
    getcontext().prec = 50
    exact = (Decimal(31) / Decimal(32)).ln() / Decimal(2).ln()
    assert abs(Decimal(POW_HI) + Decimal(POW_LO) - exact) < Decimal(1e-33)

    def fma(a, b, c):
        return float(Fraction(a) * Fraction(b) + Fraction(c))

    rng = np.random.default_rng(9)
    ts = np.concatenate([rng.random(6000) * 480, rng.random(2000) * 4,
                         np.arange(0, 480, 0.5)]).astype(F32)
    for t in ts:
        x = float(t)
        hi = x * POW_HI
        lo = fma(x, POW_HI, -hi) + x * POW_LO
        e = float(np.exp2(hi))
        got = F32(fma(e, lo * 0.69314718055994531, e))
        assert got == F32(0.96875 ** x), x


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

    monkeypatch.setattr(
        krd, "wavefront_rd_encode_planes_reference",
        counted("rd", krd.wavefront_rd_encode_planes_reference))
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
    real = krd.wavefront_rd_encode_planes_reference

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(krd, "wavefront_rd_encode_planes_reference", counted)
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
