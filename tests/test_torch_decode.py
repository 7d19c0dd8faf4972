"""The port's closed-loop decode step (`kernels.decode`) vs the JAX
package's decoder, bit-exact.

`decode_blocks_reference`, the plain version of the decode kernel, and
the port's `decode_planes` (which reaches it through the wrapper on the
CPU) must equal JAX's `decode_planes`, its compiled scan, on
adversarial streams that no encoder made: random modes 0..34 in every
block, random levels, a QP per frame, smoothing on and off at N 8, 16
and 32 (the strong filter included), 10-bit, misaligned geometries.  A
numpy model of `csrc/decode.cu`'s arithmetic (raster order, the
availability rule written instead of read, one projection array per
block) must equal the plain version too, and so must a numpy model of
its schedule (groups of W block rows, tagged words handed between rows
in shared memory, an edge buffer between groups, walked in a random
order that the polls allow); the decode routes must make one
`decode_blocks` call a plane batch.  The tolerance is 0.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu.models import wavefront as jax_wf
from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels import build
from nanohevc_tpu_torch.kernels import decode as kd
from nanohevc_tpu_torch.kernels.mode_search import angle_table
from nanohevc_tpu_torch.models import wavefront as torch_wf


def adversarial_stream(b, h, w, n, seed, sparse=0.5, dc_only=False):
    """(B, nb, N*N) scan-packed levels and (B, nb) modes of a stream no
    encoder made: random modes 0..34 in every block, and in a
    `1 - sparse` share of the blocks random levels, mostly small with a
    few large ones.  With `dc_only`, every block's levels are one DC
    level in -2..2 instead: flat residuals, so that the neighbours' arms
    are nearly flat but not constant (the strong filter's case)."""
    rng = np.random.default_rng(seed)
    nb = (-(-h // n)) * (-(-w // n))
    modes = rng.integers(0, 35, (b, nb)).astype(np.int32)
    if dc_only:
        levels = np.zeros((b, nb, n * n), np.int32)
        levels[..., 0] = rng.integers(-2, 3, (b, nb))
        return levels, modes
    mag = np.where(rng.random((b, nb, n * n)) < 0.05,
                   rng.integers(-60, 61, (b, nb, n * n)),
                   rng.integers(-3, 4, (b, nb, n * n)))
    keep = (rng.random((b, nb, n * n)) < 0.3) & (
        rng.random((b, nb, 1)) >= sparse)
    levels = np.where(keep, mag, 0).astype(np.int32)
    return levels, modes


def residual_planes(levels, modes, qps, n, hp, wp, **kw):
    """The residual that `decode_planes` hands the decode step, as
    (B, Hp, Wp) int32 planes."""
    return torch_wf.decode_residual(torch.from_numpy(levels),
                                    torch.from_numpy(modes), qps, n=n, hp=hp,
                                    wp=wp, **kw)


# (B, H, W, n, per-frame QPs, decoder keywords); the geometries are
# shared across the N, and the 120x32 one at N = 32 is one block column
# of DC-only levels, where the strong filter takes non-constant arms.
CASES = [
    (3, 40, 72, 8, [22, 30, 37], dict()),
    (3, 40, 72, 8, [30, 12, 45], dict(intra_smoothing=True)),
    (2, 40, 72, 16, [27, 33], dict(intra_smoothing=True, bit_depth=10,
                                   dequant_rescale=True)),
    (2, 40, 72, 32, [22, 40], dict(intra_smoothing=True)),
    (2, 120, 32, 32, [35, 20], dict(intra_smoothing=True, bit_depth=10)),
    (3, 37, 70, 4, [22, 30, 51], dict(use_dst=True, scan="mode")),
    (2, 37, 70, 16, [0, 28], dict(scan="horizontal")),
    (2, 37, 70, 8, [26, 31], dict(bit_depth=10, intra_smoothing=True,
                                  scan="vertical")),
]


def _case_id(case):
    b, h, w, n, qps, kw = case
    extra = "-".join(f"{k}={v}" for k, v in kw.items())
    return f"b{b}-{h}x{w}-n{n}" + (f"-{extra}" if extra else "")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_decode_matches_jax_scan(case):
    """Random modes and levels, per-frame QPs: the plain decode step and
    the port's decode_planes == JAX's decode_planes."""
    b, h, w, n, qps, kw = case
    levels, modes = adversarial_stream(b, h, w, n, seed=n + h + b,
                                       sparse=0.9 if n == 32 else 0.5,
                                       dc_only=w == n)
    want = np.asarray(jax_wf.decode_planes(
        jnp.asarray(levels), jnp.asarray(modes),
        jnp.asarray(qps, dtype=jnp.int32), n=n, height=h, width=w, **kw))
    hp, wp = -(-h // n) * n, -(-w // n) * n
    res = residual_planes(levels, modes, qps, n, hp, wp,
                          **{k: v for k, v in kw.items()
                             if k in ("use_dst", "scan", "dequant_rescale")})
    plain = kd.decode_blocks_reference(
        res, torch.from_numpy(modes), n, bit_depth=kw.get("bit_depth", 8),
        intra_smoothing=kw.get("intra_smoothing", False))
    assert plain.dtype == torch.int32
    assert np.array_equal(plain[:, :h, :w].numpy(), want)
    got = torch_wf.decode_planes(torch.from_numpy(levels),
                                 torch.from_numpy(modes), qps, n=n, height=h,
                                 width=w, **kw)
    assert np.array_equal(got.numpy(), want)
    if w == n:
        assert kernel_model(res, torch.from_numpy(modes), n,
                            kw["bit_depth"], True)[1] > 0


# --- a model of csrc/decode.cu's arithmetic ----------------------------------

class BlockModel:
    """decode.cu's arithmetic for one block in numpy: the [1 2 1] and
    strong filters where the mode's bit of `filter_mask` is set, one
    projection array for the block's mode, a mode outside 0..34 read as 2
    (below) or 34 (above), the residual added and the sum clipped."""

    def __init__(self, n, bit_depth=8, intra_smoothing=False):
        self.n = n
        tab = angle_table().astype(np.int64)
        self.angles, self.invs = tab[:33], tab[33:]
        self.mask = kd.filter_mask(n, intra_smoothing and n > 4)
        self.boundary = 1 << (bit_depth - 1)
        self.max_pix = (1 << bit_depth) - 1
        self.thresh = (1 << (bit_depth - 5) if intra_smoothing and n == 32
                       else 0)
        self.strong = 0     # blocks that took the strong filter, not flat

    def __call__(self, ref, mode, res):
        """(4N+2,) references in extract_refs' layout (corner at 0 and at
        2N+1), the signalled mode, the (N, N) residual -> (N, N) recon."""
        n = self.n
        r_, l_ = 2 * n + 1, 3 * n + 1
        shift = n.bit_length()                  # log2(N) + 1
        ii, jj = np.mgrid[0:n, 0:n]
        mode = int(mode)
        if mode not in (0, 1):
            mode = min(max(mode, 2), 34)
        if n > 4 and (self.mask >> mode) & 1:
            fc = (ref[r_ + 1] + 2 * ref[0] + ref[1] + 2) >> 2
            fref = np.empty_like(ref)
            for arm in (0, r_):
                a = ref[arm:arm + r_]
                fref[arm] = fc
                fref[arm + 1:arm + 2 * n] = (a[:-2] + 2 * a[1:-1]
                                             + a[2:] + 2) >> 2
                fref[arm + 2 * n] = a[2 * n]
            c = ref[0]
            if n == 32 and (
                    abs(c + ref[2 * n] - 2 * ref[n]) < self.thresh
                    and abs(c + ref[r_ + 2 * n] - 2 * ref[r_ + n])
                    < self.thresh):
                self.strong += (c != ref[2 * n]) or (c != ref[4 * n + 1])
                k = np.arange(1, 2 * n)
                for arm in (0, r_):
                    end = ref[arm + 2 * n]
                    fref[arm] = c
                    fref[arm + 1:arm + 2 * n] = (
                        (2 * n - k) * c + k * end + n) >> shift
            ref = fref
        top, left = ref[:r_], ref[r_:]
        if mode == 0:
            pred = ((n - 1 - jj) * left[1 + ii] + (jj + 1) * top[n]
                    + (n - 1 - ii) * top[1 + jj] + (ii + 1) * left[n]
                    + n) >> shift
        elif mode == 1:
            pred = np.full((n, n), (top[1:n + 1].sum()
                                    + left[1:n + 1].sum() + n) // (2 * n))
        else:
            angle = int(self.angles[mode - 2])
            inv = int(self.invs[mode - 2])
            vertical = mode >= 18
            prim, sec = (0, r_) if vertical else (r_, 0)
            proj = np.empty(l_, np.int64)
            for e in range(l_):
                pos = e - n
                if pos >= 0:
                    proj[e] = ref[prim + pos]
                elif angle < 0 and pos >= (n * angle) >> 5:
                    proj[e] = ref[sec + (((pos + 1) * inv + 128) >> 8)]
                else:
                    proj[e] = ref[0]
            scan, base = (ii, jj) if vertical else (jj, ii)
            p = (scan + 1) * angle
            frac = p & 31
            idx = n + base + 1 + (p >> 5)
            nxt = proj[np.minimum(idx + 1, 3 * n)]
            pred = ((32 - frac) * proj[idx] + frac * nxt + 16) >> 5
        return np.clip(pred + res, 0, self.max_pix)


def kernel_model(residual, modes, n, bit_depth=8, intra_smoothing=False):
    """decode.cu's algorithm in numpy, in raster order (each row after
    the row above, as a row's blocks see their top arms): references by
    the availability rule with the extensions written, never read, then
    `BlockModel`'s arithmetic.  `schedule_model` models the order the
    kernel's threads take: groups of rows, tagged words, the edge buffer.
    Returns (recon (B, Hp, Wp) int64, the blocks that took the strong
    filter with an arm that is not constant)."""
    res = residual.numpy().astype(np.int64)
    modes = modes.numpy().astype(np.int64)
    b, hp, wp = res.shape
    nby, nbx = hp // n, wp // n
    r_ = 2 * n + 1
    block = BlockModel(n, bit_depth, intra_smoothing)
    boundary = block.boundary
    recon = np.zeros_like(res)
    for f in range(b):
        for by in range(nby):
            for bx in range(nbx):
                y0, x0 = by * n, bx * n
                rec = recon[f]
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
                rec[y0:y0 + n, x0:x0 + n] = block(
                    ref, modes[f, by * nbx + bx],
                    res[f, y0:y0 + n, x0:x0 + n])
    return recon, block.strong


TAG_SHIFT = 17         # a shared line word: (tag << 17) | (pixel + 1)


def schedule_model(residual, modes, n, bit_depth=8, intra_smoothing=False,
                   *, rows, grid, seed, tags=32767):
    """decode.cu's schedule in numpy, its threads' steps taken in a
    random order (seeded) that the words they poll allow.

    `grid` thread blocks take groups of `rows` block rows of one plane by
    ticket, (group outer, plane inner), and a new ticket only once every
    row of their group is done.  A row of a group hands its bottom line
    to the row below through its thread block's line buffer, words
    (tag << 17) | (pixel + 1) with the tag 1 + (groups taken - 1) %
    `tags`, the lines cleared when it wraps and never otherwise; the
    group's last row hands it to the next group through the edge buffer
    of pixel + 1 words, zeroed once.  A row goes ahead with block bx once
    the N words above it carry their tag (or are nonzero), and builds its
    references from those words, the corner and the left arm it kept,
    and the availability rule; the recon is written and never read.  It
    asserts that every word read was written by the block above, with
    that block's pixel, and that the walk ends with every block done.
    Returns (recon, blocks that took the strong filter non-flat)."""
    res = residual.numpy().astype(np.int64)
    modes = modes.numpy().astype(np.int64)
    b, hp, wp = res.shape
    nby, nbx = hp // n, wp // n
    r_ = 2 * n + 1
    groups = -(-nby // rows)
    block = BlockModel(n, bit_depth, intra_smoothing)
    boundary = block.boundary
    rng = np.random.default_rng(seed)
    recon = np.full_like(res, -1)
    done = np.zeros((b, nby, nbx), bool)
    # the wrapper's zeroed work buffer: the ticket, then the edge buffer
    work = np.zeros(kd.work_ints(b, hp, wp, n, rows), np.int64)
    edge = work[1:].reshape(b, groups - 1, wp)
    blocks = [dict(lines=rng.integers(0, 1 << 32, (rows - 1, wp)),
                   local=0, group=None, teams=[]) for _ in range(grid)]
    for tb in blocks:                   # the kernel clears them first
        tb["lines"][:] = 0
    ticket = 0

    def ready(tb, w, team):
        f, gi = tb["group"]
        by, bx = gi * rows + w, team["bx"]
        if by == 0:
            return True
        x0 = bx * n
        if w == 0:
            return bool((edge[f, gi - 1, x0:x0 + n] != 0).all())
        return bool((tb["lines"][w - 1, x0:x0 + n] >> TAG_SHIFT
                     == tb["tag"]).all())

    def step(tb, w, team):
        f, gi = tb["group"]
        by, bx = gi * rows + w, team["bx"]
        y0, x0 = by * n, bx * n
        ref = np.zeros(2 * r_, np.int64)
        if by == 0:
            ref[:r_] = boundary
        else:
            if w == 0:
                top = edge[f, gi - 1, x0:x0 + n] - 1
            else:
                top = (tb["lines"][w - 1, x0:x0 + n]
                       & ((1 << TAG_SHIFT) - 1)) - 1
            assert done[f, by - 1, bx], "a word read before it was written"
            assert np.array_equal(top, recon[f, y0 - 1, x0:x0 + n]), (
                "a word read that the block above did not write")
            ref[1:n + 1] = top
            ref[n + 1:r_] = top[n - 1] if bx == nbx - 1 else 0
        if bx == 0:
            ref[r_:] = boundary
        else:
            ref[r_ + 1:r_ + n + 1] = team["left"]
            ref[r_ + n + 1:] = team["left"][n - 1] if by == nby - 1 else 0
        ref[0] = ref[r_] = (boundary if by == 0 or bx == 0
                            else team["corner"])
        out = block(ref, modes[f, by * nbx + bx],
                    res[f, y0:y0 + n, x0:x0 + n])
        recon[f, y0:y0 + n, x0:x0 + n] = out
        if by < nby - 1:                # publish the bottom line
            if w == rows - 1:
                edge[f, gi, x0:x0 + n] = out[n - 1] + 1
            else:
                tb["lines"][w, x0:x0 + n] = ((tb["tag"] << TAG_SHIFT)
                                             | (out[n - 1] + 1))
        team["corner"], team["left"] = ref[n], out[:, n - 1]
        team["bx"] += 1
        done[f, by, bx] = True

    while True:
        moves = []
        for tb in blocks:
            active = [w for w, team in enumerate(tb["teams"])
                      if team["bx"] < nbx]
            if not active and ticket < b * groups:
                moves.append((tb, None, None))
            moves += [(tb, w, tb["teams"][w]) for w in active
                      if ready(tb, w, tb["teams"][w])]
        if not moves:
            break
        tb, w, team = moves[rng.integers(len(moves))]
        if w is not None:
            step(tb, w, team)
            continue
        tb["local"] += 1
        tb["tag"] = 1 + (tb["local"] - 1) % tags
        if tb["local"] > 1 and tb["tag"] == 1:
            tb["lines"][:] = 0
        tb["group"] = (ticket % b, ticket // b)
        ticket += 1
        gi = tb["group"][1]
        tb["teams"] = [dict(bx=0 if gi * rows + w < nby else nbx,
                            corner=boundary, left=None)
                       for w in range(rows)]
    assert done.all(), "the schedule stopped with blocks left"
    return recon, block.strong


# (n, smoothing, block rows, block columns, W, grid, batch, bit depth,
#  DC-only levels, tags): N 4-32, smoothing off and on, row counts that
# are and are not multiples of W, a batch of 3, grids of 1 to 3, the
# line tags wrapping, one DC-only N=32 case that takes the strong filter.
SCHEDULE_CASES = [
    (4, False, 5, 6, 2, 2, 3, 8, False, 32767),
    (8, True, 6, 5, 3, 1, 1, 8, False, 32767),
    (8, False, 7, 4, 4, 3, 3, 10, False, 2),
    (16, True, 4, 3, 2, 2, 2, 8, False, 32767),
    (16, False, 5, 3, 4, 1, 1, 8, False, 3),
    (32, False, 3, 2, 2, 2, 1, 8, False, 32767),
    (32, True, 4, 1, 3, 2, 3, 10, True, 32767),
]


@pytest.mark.parametrize(
    "n,smoothing,nby,nbx,rows,grid,batch,bit_depth,dc_only,tags",
    SCHEDULE_CASES,
    ids=[f"n{c[0]}{'-smooth' if c[1] else ''}-{c[2]}x{c[3]}-w{c[4]}-g{c[5]}"
         f"-b{c[6]}{'-dc' if c[8] else ''}{'-wrap' if c[9] < 99 else ''}"
         for c in SCHEDULE_CASES])
def test_schedule_model_matches_plain(n, smoothing, nby, nbx, rows, grid,
                                      batch, bit_depth, dc_only, tags):
    """The kernel's schedule (groups of W rows, tagged words in the line
    buffers, the edge buffer between groups) in a random order that its
    polls allow == the plain diagonal walk, pixel for pixel."""
    h, w = nby * n, nbx * n
    levels, modes = adversarial_stream(batch, h, w, n, seed=11 * n + nby,
                                       sparse=0.9 if n == 32 else 0.5,
                                       dc_only=dc_only)
    qps = [22, 37, 30][:batch]
    res = residual_planes(levels, modes, qps, n, h, w, use_dst=n == 4)
    modes_t = torch.from_numpy(modes)
    want = kd.decode_blocks_reference(res, modes_t, n, bit_depth=bit_depth,
                                      intra_smoothing=smoothing)
    got, strong = schedule_model(res, modes_t, n, bit_depth, smoothing,
                                 rows=rows, grid=grid, seed=nby + grid,
                                 tags=tags)
    assert np.array_equal(got, want.numpy())
    if dc_only:
        assert strong > 0, "no block took the strong filter"


@pytest.mark.cuda
def test_group_rows_fits_shared_memory():
    """W is the library's default (4, or 2 at N=32) where the plane has
    the rows and the lines fit, fewer on short or very wide planes, at
    least 1, and the kernel decodes at the W it chose."""
    if not torch.cuda.is_available():
        pytest.skip("W is chosen by the kernel's library, which needs a "
                    "CUDA card; on the GPU machine chip_smoke.py phase 3f "
                    "reads it")
    dev = torch.cuda.current_device()
    assert [kd.group_rows(n, 1088, 1920, dev) for n in (4, 8, 16, 32)] == [
        4, 4, 4, 2]
    assert kd.group_rows(16, 32, 1920, dev) == 2
    assert kd.group_rows(4, 4, 64, dev) == 1
    for n, wp in ((4, 20000), (32, 60000), (16, 100000)):
        rows = kd.group_rows(n, 1088, wp, dev)
        assert 1 <= rows < kd.group_rows(n, 1088, 1920, dev)
        levels, modes = adversarial_stream(1, 2 * rows * n + n, wp, n,
                                           seed=n, sparse=0.9)
        res = residual_planes(levels, modes, [22], n, 2 * rows * n + n, wp,
                              use_dst=n == 4).cuda()
        modes_t = torch.from_numpy(modes).cuda()
        assert torch.equal(kd.decode_blocks(res, modes_t, n),
                           kd.decode_blocks_reference(res, modes_t, n))


# (n, bit depth, smoothing, blocks (rows, columns), DC-only levels)
MODEL_CASES = [
    (4, 8, False, (3, 4), False), (8, 8, False, (3, 4), False),
    (8, 8, True, (3, 4), False), (16, 10, True, (3, 4), False),
    (16, 8, False, (4, 1), False), (32, 8, False, (3, 4), False),
    (32, 8, True, (3, 4), False), (32, 8, True, (4, 1), True),
    (32, 10, True, (4, 1), True), (32, 8, True, (3, 2), True),
]


@pytest.mark.parametrize("n,bit_depth,smoothing,blocks,dc_only", MODEL_CASES,
                         ids=[f"n{n}-bd{bd}{'-smooth' if s else ''}-"
                              f"{b[0]}x{b[1]}{'-dc' if d else ''}"
                              for n, bd, s, b, d in MODEL_CASES])
def test_kernel_model_matches_plain(n, bit_depth, smoothing, blocks, dc_only):
    """What the kernel relies on: raster order with the rule, the
    filters and one projection array per block give the plain diagonal
    walk's pixels, on random modes and levels (DC-only levels on one
    block column, where the strong filter takes non-constant arms)."""
    h, w = blocks[0] * n, blocks[1] * n
    levels, modes = adversarial_stream(2, h, w, n, seed=7 * n + bit_depth,
                                       sparse=0.9 if n == 32 else 0.5,
                                       dc_only=dc_only)
    res = residual_planes(levels, modes, [22, 37], n, h, w)
    modes_t = torch.from_numpy(modes)
    want = kd.decode_blocks_reference(res, modes_t, n, bit_depth=bit_depth,
                                      intra_smoothing=smoothing)
    got, strong = kernel_model(res, modes_t, n, bit_depth, smoothing)
    assert np.array_equal(got, want.numpy())
    if dc_only and smoothing:
        assert strong > 0, "no block took the strong filter"


def test_kernel_model_reads_out_of_range_modes_as_the_plain_version():
    """The kernel has no host synchronise to check the modes on the card:
    it reads a mode below 0 as 2 and one above 34 as 34, as the plain
    version does."""
    n = 8
    levels, modes = adversarial_stream(1, 2 * n, 3 * n, n, seed=3)
    modes[0, :3] = (-4, 35, 200)
    res = residual_planes(levels, np.clip(modes, 0, 34), [30], n, 2 * n, 3 * n)
    modes_t = torch.from_numpy(modes)
    want = kd.decode_blocks_reference(res, modes_t, n, intra_smoothing=True)
    read_as = np.where((modes == 0) | (modes == 1), modes,
                       np.clip(modes, 2, 34)).astype(np.int32)
    clamped = kd.decode_blocks_reference(res, torch.from_numpy(read_as), n,
                                         intra_smoothing=True)
    assert torch.equal(want, clamped)
    got, _ = kernel_model(res, modes_t, n, 8, True)
    assert np.array_equal(got, want.numpy())


def test_filter_mask_is_mode_filter_flags():
    for n in (4, 8, 16, 32):
        flags = ops.intra.mode_filter_flags(n)
        mask = kd.filter_mask(n, True)
        assert [bool((mask >> m) & 1) for m in range(35)] == flags.tolist()
        assert kd.filter_mask(n, False) == 0
    assert kd.filter_mask(4, True) == 0


# --- the wrapper -------------------------------------------------------------

def test_wrapper_on_cpu_is_the_plain_version():
    n = 8
    levels, modes = adversarial_stream(2, 24, 40, n, seed=5)
    res = residual_planes(levels, modes, [25, 33], n, 24, 40)
    modes_t = torch.from_numpy(modes)
    before = (kd.decode_blocks.launches, kd.decode_blocks.grids)
    got = kd.decode_blocks(res, modes_t, n, intra_smoothing=True)
    want = kd.decode_blocks_reference(res, modes_t, n, intra_smoothing=True)
    assert (kd.decode_blocks.launches, kd.decode_blocks.grids) == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", [
    "dtype", "dims", "contiguous", "aligned", "n", "bit_depth",
    "modes_shape", "modes_dtype", "modes_contiguous", "modes_range",
    "modes_negative",
])
def test_wrapper_validates_input(bad):
    res = torch.zeros((2, 16, 24), dtype=torch.int32)
    modes = torch.ones((2, 6), dtype=torch.int32)
    n, bit_depth = 8, 8
    if bad == "dtype":
        res = res.to(torch.int64)
    elif bad == "dims":
        res = res[0]
    elif bad == "contiguous":
        res = torch.zeros((2, 24, 16), dtype=torch.int32).transpose(1, 2)
    elif bad == "aligned":
        res = res[:, :, :20].contiguous()
    elif bad == "n":
        n = 6
    elif bad == "bit_depth":
        bit_depth = 17
    elif bad == "modes_shape":
        modes = modes[:, :5].contiguous()
    elif bad == "modes_dtype":
        modes = modes.to(torch.int64)
    elif bad == "modes_contiguous":
        modes = torch.ones((6, 2), dtype=torch.int32).t()
    elif bad == "modes_range":
        modes[1, 3] = 35
    else:
        modes[0, 0] = -1
    with pytest.raises((TypeError, ValueError)):
        kd.decode_blocks(res, modes, n, bit_depth=bit_depth)


def test_cpu_path_builds_and_loads_no_cuda_code(monkeypatch):
    """On the CPU, decode_blocks and every decode route run the plain
    version and never reach the CUDA build or loader."""
    def refuse(*args, **kwargs):
        raise AssertionError("CUDA code built or loaded on the CPU path")

    monkeypatch.setattr(kd, "cuda_kernels", refuse)
    monkeypatch.setattr(build, "build_libraries", refuse)
    monkeypatch.setattr(build, "load_library", refuse)
    n = 8
    levels, modes = adversarial_stream(1, 21, 30, n, seed=9)
    got = torch_wf.decode_plane(torch.from_numpy(levels[0]),
                                torch.from_numpy(modes[0]), 30, n=n,
                                height=21, width=30, intra_smoothing=True)
    res = residual_planes(levels, modes, [30], n, 24, 32)
    want = kd.decode_blocks(res, torch.from_numpy(modes), n,
                            intra_smoothing=True)
    assert torch.equal(got, want[0, :21, :30])


def test_decode_routes_call_the_kernel_once_a_plane_batch(monkeypatch,
                                                          tmp_path):
    """decode_frame makes one decode_blocks call a plane, decode_sequence
    one a plane a chunk of 8 frames (on the card, one kernel launch
    each), and both still give the encoder's recon."""
    from nanohevc_tpu_torch.config import EncoderConfig
    from nanohevc_tpu_torch.frame import Frame, Plane
    from nanohevc_tpu_torch.models import sequence as seq

    calls = []

    def spy(residual, modes, n, **kw):
        calls.append(residual.shape[0])
        return kd.decode_blocks(residual, modes, n, **kw)

    monkeypatch.setattr(torch_wf, "decode_blocks", spy)
    rng = np.random.default_rng(4)
    frames = [Frame(*(Plane(rng.integers(0, 256, s).astype(np.int16))
                      for s in ((24, 40), (12, 20), (12, 20))))
              for _ in range(10)]
    recon, bits = torch_wf.encode_frame_closed_loop(
        frames[0], EncoderConfig(intra_smoothing=True), device="cpu")
    dec = torch_wf.decode_frame(bits, device="cpu")
    assert calls == [1, 1, 1]
    assert all(np.array_equal(getattr(dec, k).data, getattr(recon, k).data)
               for k in "yuv")
    src, out, yuv = (tmp_path / f for f in ("s.yuv", "s.bin", "d.yuv"))
    src.write_bytes(b"".join(f.to_yuv420p() for f in frames))
    seq.encode_sequence(str(src), 40, 24, 10, EncoderConfig(), str(out),
                        closed_loop=True, resume=False, device="cpu")
    calls.clear()
    assert seq.decode_sequence(str(out), str(yuv), device="cpu") == 10
    assert calls == [8, 8, 8, 2, 2, 2]
    want = b"".join(torch_wf.encode_frame_closed_loop(
        f, EncoderConfig(), device="cpu")[0].to_yuv420p() for f in frames)
    assert yuv.read_bytes() == want


@pytest.mark.cuda
@pytest.mark.parametrize("n,smoothing", [(4, False), (8, True), (16, True),
                                         (32, True)])
def test_cuda_kernel_matches_plain(n, smoothing):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine chip_smoke.py "
                    "phase 3f runs this check")
    # 3 block rows (one group), and 11, which W (4, or 2 at N=32) does
    # not divide
    for nby in (3, 11):
        assert nby == 3 or nby % kd.group_rows(n, nby * n, 5 * n,
                                               torch.cuda.current_device())
        levels, modes = adversarial_stream(3, nby * n, 5 * n, n, seed=n,
                                           sparse=0.9 if n == 32 else 0.5)
        res = residual_planes(levels, modes, [22, 30, 37], n, nby * n, 5 * n,
                              use_dst=n == 4).cuda()
        modes_t = torch.from_numpy(modes).cuda()
        got = kd.decode_blocks(res, modes_t, n, intra_smoothing=smoothing)
        want = kd.decode_blocks_reference(res, modes_t, n,
                                          intra_smoothing=smoothing)
        assert torch.equal(got, want)
