"""The port's level-prefix transfer (`ops.sparse`) vs the JAX package's.

Every case of tests/test_sparse.py, on the same seeded level tensors:
the port's `compact_levels` header equals JAX's, and the port's
`fetch_levels` gives back the tensor exactly, as JAX's does; plus the
int16-overflow fallback, the missing-dense error and the bucket rule.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nanohevc_tpu.ops import sparse as jax_sparse
from nanohevc_tpu_torch.ops import sparse


def _density(density):
    def make():
        rng = np.random.default_rng(42)
        lv = rng.integers(-800, 800, (3, 50, 16)).astype(np.int32)
        lv[rng.random(lv.shape) >= density] = 0
        return lv
    return make


def _ends():
    lv = np.zeros((1, 4, 16), np.int32)
    lv.flat[0] = -5
    lv.flat[-1] = 7
    return lv


def _lastpos(lastpos):
    def make():
        lv = np.zeros((2, 6, 64), np.int32)
        lv[1, 3, lastpos] = -9
        lv[0, 0, 0] = 2
        return lv
    return make


def _extremes():
    lv = np.zeros((1, 2, 16), np.int32)
    lv[0, 0, 0] = 32767
    lv[0, 1, 3] = -32767
    return lv


def _two_d():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 9, (40, 64))
            * (rng.random((40, 64)) < 0.1)).astype(np.int32)


def _header_case():
    lv = np.zeros((2, 3, 8), np.int32)
    lv[0, 0, 0] = -9
    lv[1, 2, 5] = 4
    return lv


def _full_prefix():
    rng = np.random.default_rng(3)
    return rng.integers(1, 5, (2, 20, 16)).astype(np.int32)


def _overflow():
    lv = np.zeros((1, 2, 16), np.int32)
    lv[0, 0, 0] = 40000          # outside int16
    return lv


CASES = {
    **{f"density-{d}": _density(d) for d in (0.0, 0.01, 0.3, 1.0)},
    "all-zero": lambda: np.zeros((2, 10, 16), np.int32),
    "all-zero-2d": lambda: np.zeros((3, 4), np.int32),
    "single-nonzero-at-each-end": _ends,
    **{f"lastpos-{p}": _lastpos(p) for p in (0, 3, 4, 5, 15, 63)},
    "int16-extremes": _extremes,
    "2d-shape": _two_d,
    "prefix-and-max-abs": _header_case,
    "full-prefix-is-dense": _full_prefix,
    "overflow-uses-dense": _overflow,
}


@pytest.mark.parametrize("name", list(CASES))
def test_header_and_roundtrip_match_jax(name):
    lv = CASES[name]()
    dense_j = jnp.asarray(lv)
    sparse_j = jax.jit(jax_sparse.compact_levels)(dense_j)
    dense_t = torch.from_numpy(lv)
    sparse_t = sparse.compact_levels(dense_t)
    header = sparse_t["header"]
    assert header.dtype == torch.int32 and header.shape == (2,)
    assert np.array_equal(header.numpy(), np.asarray(sparse_j["header"]))
    got = sparse.fetch_levels(sparse_t, lv.shape, dense=dense_t)
    want = jax_sparse.fetch_levels(sparse_j, lv.shape, dense=dense_j)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got, lv)


def test_header_values():
    prefix, max_abs = sparse.compact_levels(
        torch.from_numpy(_header_case()))["header"].tolist()
    assert (prefix, max_abs) == (6, 9)          # last occupied position 5


def test_prefix_is_fetched_as_int16(monkeypatch):
    """The prefix slice crosses as int16, the overflow case as int32."""
    seen = []
    real = torch.Tensor.cpu

    def spy(self, *a, **kw):
        seen.append(self.dtype)
        return real(self, *a, **kw)

    for make, want in ((_density(0.3), torch.int16), (_overflow, torch.int32)):
        lv = make()
        dense = torch.from_numpy(lv)
        header = sparse.compact_levels(dense)
        seen.clear()
        monkeypatch.setattr(torch.Tensor, "cpu", spy)
        sparse.fetch_levels(header, lv.shape, dense=dense)
        monkeypatch.setattr(torch.Tensor, "cpu", real)
        assert seen[-1] == want


def test_missing_dense_raises():
    lv = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="dense"):
        sparse.fetch_levels(sparse.compact_levels(lv), lv.shape)


@pytest.mark.parametrize("need,ncoef", [(1, 1024), (4, 1024), (5, 1024),
                                        (9, 64), (33, 64), (10**9, 64)])
def test_bucket_rounding_matches_jax(need, ncoef):
    assert sparse._MIN_PREFIX == jax_sparse._MIN_PREFIX == 4
    assert sparse._bucket(need, ncoef) == jax_sparse._bucket(need, ncoef)
