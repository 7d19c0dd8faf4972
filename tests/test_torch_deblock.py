"""The port's deblocking filter vs the JAX package's and the numpy
oracle, bit-exact.

Seeded blocky planes (8x8 blocks of flat or sloped content with noise,
so that edges see strong, weak and no filtering) go through
`nanohevc_tpu.ops.deblock_plane`, the port's copy of the numpy oracle
`ref/deblock.py` and `nanohevc_tpu_torch.ops.deblock_plane` on the CPU.
The tolerance is 0.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu.ops import deblock_plane as jax_deblock
from nanohevc_tpu_torch.ops import deblock_plane
from nanohevc_tpu_torch.ops.deblock import _params
from nanohevc_tpu_torch.ref import deblock as oracle

QPS = [0, 16, 18, 22, 30, 37, 45, 51]


def blocky(h, w, bit_depth, seed):
    """8x8 blocks: a flat level, a gentle slope or noise each, plus a
    little noise: block edges of every strength."""
    rng = np.random.default_rng(seed)
    pix_max = (1 << bit_depth) - 1
    nby, nbx = -(-h // 8), -(-w // 8)
    level = rng.integers(pix_max // 4, 3 * pix_max // 4, (nby, nbx))
    step = rng.integers(0, 6 << (bit_depth - 8), (nby, nbx))
    up = np.kron(level, np.ones((8, 8), int))[:h, :w]
    y, x = np.mgrid[:h, :w]
    slope = np.kron(step, np.ones((8, 8), int))[:h, :w] * ((x % 8) - 4) // 4
    noise = rng.integers(-2, 3, (h, w)) << (bit_depth - 8)
    return np.clip(up + slope + noise, 0, pix_max).astype(np.int32)


def both(plane, qp, bit_depth, is_chroma):
    want = np.asarray(jax_deblock(jnp.asarray(plane), qp, bit_depth,
                                  is_chroma))
    got = deblock_plane(torch.from_numpy(plane), qp, bit_depth, is_chroma)
    assert got.dtype == torch.int32
    return want, got.numpy()


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("is_chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("qp", QPS)
def test_deblock_plane_equals_jax_and_oracle(qp, is_chroma, bit_depth):
    plane = blocky(40, 56, bit_depth, qp + 100 * is_chroma)
    want, got = both(plane, qp, bit_depth, is_chroma)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle.deblock_plane(plane, qp, bit_depth,
                                                    is_chroma))
    if qp >= 30:          # the filter did act on this content
        assert not np.array_equal(got, plane)


@pytest.mark.parametrize("shape", [(38, 50), (22, 64), (8, 13)])
def test_height_not_a_multiple_of_4(shape):
    """Rows past the last full 4-row segment stay unfiltered, and a
    plane too narrow for an edge passes through."""
    plane = blocky(*shape, 8, sum(shape))
    for is_chroma in (False, True):
        want, got = both(plane, 37, 8, is_chroma)
        assert np.array_equal(got, want)
        assert np.array_equal(got, oracle.deblock_plane(plane, 37, 8,
                                                        is_chroma))


@pytest.mark.parametrize("is_chroma", [False, True], ids=["luma", "chroma"])
def test_batch_with_two_qps(is_chroma):
    """A (B,) QP tensor filters each plane of a batch at its own QP."""
    planes = np.stack([blocky(32, 40, 8, 7), blocky(32, 40, 8, 8)])
    qps = [22, 45]
    got = deblock_plane(torch.from_numpy(planes), torch.tensor(qps), 8,
                        is_chroma).numpy()
    for plane, g, qp in zip(planes, got, qps):
        assert np.array_equal(g, np.asarray(jax_deblock(
            jnp.asarray(plane), qp, 8, is_chroma)))
    assert not np.array_equal(got[1], deblock_plane(
        torch.from_numpy(planes[1]), 22, 8, is_chroma).numpy())


@pytest.mark.parametrize("bit_depth", [8, 10, 12])
def test_params_follow_table_8_12(bit_depth):
    for qp in range(-3, 56):
        want = oracle.filter_params(qp, bit_depth)
        assert _params(qp, bit_depth, torch.zeros(1)) == want, qp
        beta, tc = _params(torch.tensor([qp]), bit_depth, torch.zeros(1, 4, 4))
        assert beta.shape == tc.shape == (1, 1, 1)
        assert (int(beta), int(tc)) == want, qp
