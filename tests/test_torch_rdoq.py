"""The port's RDOQ vs the JAX package's, bit for bit.

`rd_lambda_calibrated` is pinned over every QP, block size, DST and
dequant mode; `rdoq_levels` on transform coefficients of seeded
textured residuals (the blocks and deadzone levels a plane encode
feeds it) must give JAX's levels exactly, at N 4 (DCT and DST) to 32,
QP 12/22/37, both dequant modes and the three scans, and with a table
and lambda of the caller's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nanohevc_tpu import ops as jops
from nanohevc_tpu.ops import rate as j_rate
from nanohevc_tpu.ops import rdoq as j_rdoq
from nanohevc_tpu_torch import ops as tops
from nanohevc_tpu_torch.ops import rate as t_rate
from nanohevc_tpu_torch.ops import rdoq as t_rdoq

SIZES = [(4, True), (4, False), (8, False), (16, False), (32, False)]


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("n,dst", SIZES)
def test_rd_lambda_calibrated_matches_jax(n, dst, rescale):
    f = jax.jit(lambda q: j_rdoq.rd_lambda_calibrated(q, n, dst, rescale, 1.3))
    for qp in range(52):
        want = np.float32(f(jnp.int32(qp)))
        got = t_rdoq.rd_lambda_calibrated(qp, n, dst, rescale, 1.3)
        assert isinstance(got, np.float32)
        assert got.tobytes() == want.tobytes(), qp
    assert (t_rdoq.rd_lambda_calibrated(22, n, dst, rescale).tobytes()
            == np.float32(j_rdoq.rd_lambda_calibrated(22, n, dst, rescale))
            .tobytes())


@pytest.mark.parametrize("n,dst", SIZES)
def test_gain_matrix_and_last_cost_match_jax(n, dst):
    want = j_rdoq._gain_matrix(n, dst)
    got = t_rdoq._gain_matrix(n, dst)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert torch.equal(tops.rdoq_gain(n, dst), torch.from_numpy(want))
    t = j_rate.default_table(n * n)
    key = (float(t.lastfull0), float(t.lastfull1),
           tuple(float(x) for x in t.lastp0), tuple(float(x) for x in t.lastp1))
    assert np.array_equal(t_rdoq._last_cost_vec(n * n, key),
                          j_rdoq._last_cost_vec(n * n, key))


def residual_blocks(seed, nb, n, bit_depth=8):
    """Residuals of textured blocks against their DC prediction: smooth
    ramps, edges and noise, a few flat blocks."""
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:n, 0:n]
    blocks = []
    for i in range(nb):
        gx, gy = rng.integers(-12, 13, 2)
        edge = (xx + yy * rng.integers(-2, 3) > n // 2) * rng.integers(-90, 91)
        b = 128 + gx * xx + gy * yy + edge + rng.integers(-30, 31, (n, n))
        if i % 9 == 0:
            b = np.full((n, n), rng.integers(0, peak + 1))
        b = np.clip(b * (peak // 255), 0, peak)
        blocks.append(b - int(b.mean()))
    return np.stack(blocks).astype(np.int32)


def _case(seed, n, dst, qp, rescale, scan, bit_depth=8, nb=160):
    """JAX's scan-packed (coeff, levels, gain, modes) for seeded blocks."""
    res = residual_blocks(seed, nb, n, bit_depth)
    coeff = jops.forward_transform(jnp.asarray(res), dst)
    levels = jops.quantize(coeff, qp, n, True)
    modes = jnp.asarray(np.random.default_rng(seed).integers(0, 35, nb)
                        .astype(np.int32))
    gain = jnp.broadcast_to(j_rdoq.rdoq_gain(n, dst), coeff.shape)
    return tuple(np.array(jops.scan_pack(x, scan, modes=modes))
                 for x in (coeff, levels, gain)) + (np.asarray(modes),)


def _both(pc, pl, pg, qp, n, lam_j, lam_t, rescale, jt=None, tt=None):
    want = np.asarray(jax.jit(
        lambda a, b, c, q: j_rdoq.rdoq_levels(a, b, c, q, n, lam_j,
                                              dequant_rescale=rescale,
                                              table=jt))(pc, pl, pg, jnp.int32(qp)))
    got = tops.rdoq_levels(torch.from_numpy(pc), torch.from_numpy(pl),
                           torch.from_numpy(pg), qp, n, lam_t,
                           dequant_rescale=rescale, table=tt)
    return want, got


# lambda scales at which RDOQ trims or drops part of the levels, per N
ACTIVE_SCALE = {4: 6.0, 8: 6.0, 16: 20.0, 32: 40.0}


@pytest.mark.parametrize("strong", [False, True], ids=["calibrated", "active"])
@pytest.mark.parametrize("qp", [12, 22, 37])
@pytest.mark.parametrize("n,dst", SIZES)
def test_rdoq_levels_match_jax(n, dst, qp, strong):
    """At the calibrated lambda, and scaled to where RDOQ changes part
    of the levels (every case with nonzero levels)."""
    scale = ACTIVE_SCALE[n] if strong else 1.0
    pc, pl, pg, _ = _case(n * 100 + qp, n, dst, qp, False, "diag")
    lam_j = j_rdoq.rd_lambda_calibrated(jnp.int32(qp), n, dst, False, scale)
    lam_t = t_rdoq.rd_lambda_calibrated(qp, n, dst, False, scale)
    want, got = _both(pc, pl, pg, qp, n, lam_j, lam_t, False)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if strong and (pl != 0).any():
        assert (want != pl).any()


@pytest.mark.parametrize("scan", ["horizontal", "vertical", "mode"])
@pytest.mark.parametrize("n,rescale,bit_depth", [
    (4, True, 10), (8, True, 8), (16, True, 10), (32, False, 10)])
def test_rdoq_levels_scans_rescale_10bit(n, rescale, bit_depth, scan):
    qp = 27
    pc, pl, pg, _ = _case(n + 7, n, False, qp, rescale, scan, bit_depth)
    lam_j = j_rdoq.rd_lambda_calibrated(jnp.int32(qp), n, False, rescale, 2.0)
    lam_t = t_rdoq.rd_lambda_calibrated(qp, n, False, rescale, 2.0)
    want, got = _both(pc, pl, pg, qp, n, lam_j, lam_t, rescale)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 8])
def test_rdoq_levels_with_a_calibrated_table(n):
    """A caller's table and lambda replace the defaults on both sides."""
    qp = 22
    pc, pl, pg, _ = _case(n + 3, n, False, qp, False, "diag")
    jt = j_rate.calibrate_rate_table(pl)
    tt = t_rate.RateTable(**dataclasses.asdict(jt))
    want, got = _both(pc, pl, pg, qp, n, 40.0, 40.0, False, jt, tt)
    assert np.array_equal(got.numpy(), want)


def near_flat_blocks(seed, nb, n):
    """Residuals of nearly flat blocks, a few levels of noise on a faint
    ramp, with some textured ones: many levels near the deadzone and
    RDOQ decisions near a tie, across the whole scan."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    out = []
    for i in range(nb):
        amp = int(rng.choice([2, 4, 16, 64, 128]))
        b = (rng.integers(-amp, amp + 1, (n, n))
             + (rng.integers(-2, 3) * xx + rng.integers(-2, 3) * yy)
             // int(rng.integers(4, 17)))
        out.append(b - int(b.mean()))
    return np.stack(out).astype(np.int32)


def test_rdoq_levels_n32_no_flips_against_jax():
    """The hunt for flips at N=32, where the port's ordered_cumsum keeps
    runs of 16 and XLA's CPU cumsum changes its order past the 288th
    prefix (test_torch_rate.py::test_ordered_cumsum_long_rows): QPs over
    0..51, the three scans, the dequant rescale on and off, two lambda
    scales, one compile per rescale.  No block's levels may differ."""
    n = 32
    fns = {r: jax.jit(lambda a, b, c, q, lam, r=r: j_rdoq.rdoq_levels(
        a, b, c, q, n, lam, dequant_rescale=r)) for r in (False, True)}
    gain = jnp.broadcast_to(j_rdoq.rdoq_gain(n, False), (24, n, n))
    late = changed = 0
    for qp in (0, 4, 9, 13, 18, 22, 27, 32, 37, 44, 51):
        res = near_flat_blocks(qp, 24, n)
        coeff = jops.forward_transform(jnp.asarray(res), False)
        levels = jops.quantize(coeff, qp, n, True)
        for scan in ("diag", "horizontal", "vertical"):
            pc, pl, pg = (np.array(jops.scan_pack(x, scan))
                          for x in (coeff, levels, gain))
            for rescale in (False, True):
                for scale in (1.0, 16.0):
                    lam = t_rdoq.rd_lambda_calibrated(qp, n, False, rescale,
                                                      scale)
                    want = np.asarray(fns[rescale](pc, pl, pg, jnp.int32(qp),
                                                   jnp.float32(lam)))
                    got = tops.rdoq_levels(
                        torch.from_numpy(pc), torch.from_numpy(pl),
                        torch.from_numpy(pg), qp, n, lam,
                        dequant_rescale=rescale).numpy()
                    flips = np.flatnonzero((got != want).any(axis=1))
                    assert flips.size == 0, (qp, scan, rescale, scale, flips)
                    changed += int((want != pl).any(axis=1).sum())
                    late += int((pl[:, 288:] != 0).any(axis=1).sum())
    assert changed > 0 and late > 0     # RDOQ acted, past prefix 288 too


def test_rdoq_never_raises_a_level():
    pc, pl, pg, _ = _case(5, 8, False, 12, False, "diag")
    got = tops.rdoq_levels(torch.from_numpy(pc), torch.from_numpy(pl),
                           torch.from_numpy(pg), 12, 8, 500.0).numpy()
    assert (np.abs(got) <= np.abs(pl)).all()
    assert ((got == 0) | (np.sign(got) == np.sign(pl))).all()
    assert (got != pl).any()
