"""The port's rate models and their float32 building blocks vs JAX's.

Seeded numpy inputs go through `nanohevc_tpu.ops.{rate,mode_rate,
metrics}` (on the CPU) and `nanohevc_tpu_torch.ops.*` (on the CPU).
What JAX computes on integers is pinned exactly over its whole domain:
the lambda table over QP 0..51, the EG0 floor(log2) over 1..2^22, the
MPM lists and bits over all 35 x 35 neighbour pairs.  The static rate
model, the float32 sums and short prefix sums must be bit for bit
JAX's; the adaptive model's prices take their transcendentals in
float64 on the host, so it is held within rtol 1e-5 of the jitted
model (most rows exact).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nanohevc_tpu.models import all_intra as jax_ai
from nanohevc_tpu.ops import metrics as j_metrics
from nanohevc_tpu.ops import mode_rate as j_mode_rate
from nanohevc_tpu.ops import rate as j_rate
from nanohevc_tpu_torch import ops as tops
from nanohevc_tpu_torch.ops import mode_rate as t_mode_rate
from nanohevc_tpu_torch.ops import rate as t_rate

NCOEFS = [16, 64, 256, 1024]


def levels_batch(seed, nb, ncoef, peak=40):
    """Scan-packed levels shaped like real blocks: density falling with
    the scan position, a few all-zero rows, a full row, large levels."""
    rng = np.random.default_rng(seed)
    density = np.linspace(0.7, 0.02, ncoef) * rng.random((nb, 1)) * 2
    lv = np.where(rng.random((nb, ncoef)) < density,
                  rng.integers(-peak, peak + 1, (nb, ncoef)), 0)
    lv[:4] = 0
    lv[4, :] = 1
    lv[5, -1] = -3
    lv[6, 0] = 9000                        # past EG0's 8192 deviation
    return lv.astype(np.int32)


def wide_floats(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-12, 12, shape))).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.7, 2.5])
def test_rd_lambda_table_matches_jax(scale):
    """_rd_lambda over QP 0..51: the exp2 table and the weak-typed
    float32 product with scale * 0.57, bit for bit."""
    f = jax.jit(lambda q: jax_ai._rd_lambda(q, scale))
    want = np.array([np.asarray(f(jnp.int32(q))) for q in range(52)],
                    np.float32)
    got = np.array([t_rate._rd_lambda(q, scale) for q in range(52)],
                   np.float32)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


def test_rd_lambda_table_is_jax_exp2():
    """The table holds XLA's exp2 (not the correctly rounded value: at
    QP 51 it is 2^13 plus 4 ulps)."""
    e = jax.jit(lambda q: jnp.exp2((q.astype(jnp.float32) - 12.0) / 3.0))
    want = np.asarray(e(jnp.arange(52, dtype=jnp.int32)))
    assert t_rate._RD_EXP2_BITS.tolist() == want.tolist()
    assert t_rate._RD_EXP2_BITS[51] != np.float32(8192.0)


def test_eg0_floor_log2_matches_jax_over_the_domain():
    k = np.arange(1, (1 << 22) + 1, dtype=np.int32)
    want = np.asarray(jax.jit(
        lambda a: jnp.floor(jnp.log2(jnp.maximum(a, 1).astype(jnp.float32)))
    )(jnp.asarray(k)))
    got = t_rate.eg0_floor_log2(torch.from_numpy(k)).numpy()
    assert np.array_equal(got, want)
    exact = np.floor(np.log2(k.astype(np.float64)))
    assert k[want != exact].tolist() == [8192, 32768, 2097151, 4194303]


@pytest.mark.parametrize("ncoef", NCOEFS)
def test_ordered_sum_matches_jax(ncoef):
    x = wide_floats(ncoef, (600, ncoef))
    want = np.asarray(jax.jit(lambda a: a.sum(axis=-1))(x))
    got = t_rate.ordered_sum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("ncoef", [9, 16, 64, 256])
def test_ordered_cumsum_matches_jax(ncoef):
    x = wide_floats(ncoef + 1, (120, ncoef))
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    got = t_rate.ordered_cumsum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()


def test_ordered_cumsum_long_rows():
    """At 1024 terms XLA changes its order after the 288th prefix; the
    port keeps runs of 16: bit for bit up to there, within float32
    rounding after (ROADMAP queue 3)."""
    x = np.abs(wide_floats(1024, (60, 1024)))
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    got = t_rate.ordered_cumsum(torch.from_numpy(x)).numpy()
    assert got[:, :288].tobytes() == want[:, :288].tobytes()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _tables(ncoef):
    """The default table and one calibrated from seeded levels."""
    lv = levels_batch(ncoef + 7, 400, ncoef)
    return [j_rate.default_table(ncoef), j_rate.calibrate_rate_table(lv)]


@pytest.mark.parametrize("ncoef", NCOEFS)
def test_calibrate_rate_table_matches_jax(ncoef):
    lv = levels_batch(ncoef + 7, 400, ncoef)
    want = dataclasses.asdict(j_rate.calibrate_rate_table(lv))
    got = dataclasses.asdict(t_rate.calibrate_rate_table(lv))
    assert got == want


@pytest.mark.parametrize("which", ["default", "calibrated"])
@pytest.mark.parametrize("ncoef", NCOEFS)
def test_static_model_bits_match_jax(ncoef, which):
    """Against JAX's model_bits called op by op, as its callers do (its
    device copy of a table is cached per table, so it is not jitted)."""
    jt = _tables(ncoef)[which == "calibrated"]
    tt = t_rate.RateTable(**dataclasses.asdict(jt))
    lv = levels_batch(ncoef, 500, ncoef)
    j_rate._table_arrays.cache_clear()
    want = np.asarray(j_rate.model_bits(jnp.asarray(lv), jt))
    got = tops.rate_model_bits(torch.from_numpy(lv), tt).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("peak", [3, 40])
@pytest.mark.parametrize("ncoef", NCOEFS)
def test_adaptive_model_bits_match_jax(ncoef, peak):
    lv = levels_batch(ncoef + peak, 500, ncoef, peak)
    want = np.asarray(jax.jit(j_rate.model_bits_adaptive)(lv))
    got = tops.rate_model_bits_adaptive(torch.from_numpy(lv)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert (got == want).mean() > 0.5


def test_ctx_total_matches_jax():
    n = np.array([0, 1, 2, 5, 40, 1000, 123456, 3, 3, 77], np.float32)
    n1 = np.array([0, 0, 1, 4, 3, 999, 17, 0, 3, 40], np.float32)
    want = np.asarray(jax.jit(j_rate._ctx_total)(n1, n))
    np.testing.assert_allclose(t_rate._ctx_total(n1, n), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("ncoef", [16, 64])
def test_adaptive_counts_add_over_sub_batches(ncoef):
    """Counting a batch in pieces and pricing once gives the one-call
    bits exactly (the 35-mode RD search counts its chunks so)."""
    lv = torch.from_numpy(levels_batch(ncoef + 3, 300, ncoef))
    whole = t_rate.adaptive_counts(lv)
    parts = sum(t_rate.adaptive_counts(p) for p in torch.split(lv, 70))
    assert torch.equal(parts, whole)
    prices = t_rate.adaptive_prices(parts, ncoef)
    bits = torch.cat([t_rate.adaptive_bits(p, prices)
                      for p in torch.split(lv, 70)])
    assert torch.equal(bits, t_rate.model_bits_adaptive(lv))


def test_adaptive_prices_of_an_empty_batch():
    """All rows uncoded: every block costs the cbf0 price, finite."""
    lv = torch.zeros((8, 16), dtype=torch.int32)
    got = tops.rate_model_bits_adaptive(lv).numpy()
    want = np.asarray(jax.jit(j_rate.model_bits_adaptive)(np.zeros((8, 16), np.int32)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_estimate_bits_and_nonzero_match_jax(n):
    lv = levels_batch(n, 60, n * n).reshape(60, n, n)
    want = np.asarray(jax.jit(j_metrics.estimate_bits_blocks)(lv))
    got = tops.estimate_bits_blocks(torch.from_numpy(lv)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    want_nz = np.asarray(j_metrics.count_nonzero_blocks(jnp.asarray(lv)))
    got_nz = tops.count_nonzero_blocks(torch.from_numpy(lv)).numpy()
    assert got_nz.dtype == want_nz.dtype and np.array_equal(got_nz, want_nz)


def test_mpm_lists_and_bits_over_all_neighbour_pairs():
    a, b = np.meshgrid(np.arange(35), np.arange(35), indexing="ij")
    a, b = a.reshape(-1).astype(np.int32), b.reshape(-1).astype(np.int32)
    want = np.asarray(j_mode_rate.mpm_lists(a, b))
    got = t_mode_rate.mpm_lists(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    want_bits = np.asarray(j_mode_rate.mpm_mode_bits(a, b))
    got_bits = t_mode_rate.mpm_mode_bits(torch.from_numpy(a),
                                         torch.from_numpy(b)).numpy()
    assert got_bits.dtype == np.float32
    assert np.array_equal(got_bits, want_bits)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (7, 1), (6, 11)])
def test_mode_bits_for_grid_matches_jax(shape):
    g = np.random.default_rng(shape[0] * 31 + shape[1]).integers(
        0, 35, shape).astype(np.int32)
    g[0, 0] = 1
    ja, jb = j_mode_rate.neighbor_modes_grid(g)
    ta, tb = t_mode_rate.neighbor_modes_grid(torch.from_numpy(g))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    want = np.asarray(j_mode_rate.mode_bits_for_grid(g))
    got = t_mode_rate.mode_bits_for_grid(torch.from_numpy(g)).numpy()
    assert np.array_equal(got, want)


def test_rate_ops_exported_like_jax():
    for name in ("RateTable", "calibrate_rate_table", "rate_model_bits",
                 "rate_model_bits_adaptive", "rdoq_levels", "rdoq_gain",
                 "estimate_bits_blocks", "count_nonzero_blocks"):
        assert name in tops.__all__ and hasattr(tops, name)
    assert tops.RateTable is t_rate.RateTable
