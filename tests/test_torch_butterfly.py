"""The transforms of the row kernels (K1 `csrc/slab_pipeline.cu`, K5
`csrc/fused_pipeline.cu`, body `csrc/row_tail.cuh`), pinned on the CPU.

`forward_2d` / `inverse_2d` below are a plain int32 PyTorch formulation
that follows the kernels' order of operations: transpose (a lane gets a
column), one 1-D pass over the line, the rounding shift, transpose back
(a lane gets a row), the second 1-D pass, the rounding shift.  A 1-D
DCT pass is the kernels' recursive even/odd partial butterfly
(`ForwardButterfly` / `InverseButterfly`); the DST-VII stays a 4x4
product.  They must equal the port's `ops.forward_transform` /
`ops.inverse_transform` (float64 matrix products) and the JAX package's
(int32 einsums) exactly, with no tolerance, on seeded numpy inputs:
random residuals at 8, 10 and 12 bits, the extremes +-(2^bd - 1) as a
checkerboard and as constants, and dequantized levels at QP 0 and 51.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu import ops as jops
from nanohevc_tpu_torch import ops as tops
from nanohevc_tpu_torch.tables import transform_matrix

# (N, DST): every transform the kernels run
SIZES = [(4, False), (4, True), (8, False), (16, False), (32, False)]
BIT_DEPTHS = [8, 10, 12]


def _forward_line(a: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """y[..., u] = sum_k T[u][k] a[..., k] as `ForwardButterfly` folds
    it: at each level M (rows S*v, S = N/M) the odd rows take the
    differences of mirrored terms, the even rows recurse on the sums."""
    n = a.shape[-1]
    out = {}

    def level(a: torch.Tensor) -> None:
        m = a.shape[-1]
        s = n // m
        if m == 1:
            out[0] = int(t[0, 0]) * a[..., 0]
            return
        h = m // 2
        mirror = a.flip(-1)[..., :h]          # a[M-1-k], k < H
        e, o = a[..., :h] + mirror, a[..., :h] - mirror
        for v in range(1, m, 2):
            acc = torch.zeros_like(a[..., 0])
            for k in range(h):
                acc = acc + int(t[s * v, k]) * o[..., k]
            out[s * v] = acc
        level(e)

    level(a)
    return torch.stack([out[u] for u in range(n)], -1)


def _inverse_line(c: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """out[..., k] = sum_u T[u][k] c[..., u] as `InverseButterfly`: the
    even rows' sum E from the level below, the odd rows' sum O, then
    E + O and, mirrored, E - O."""
    n = c.shape[-1]

    def level(m: int) -> list:
        s = n // m
        if m == 1:
            return [int(t[0, 0]) * c[..., 0]]
        h = m // 2
        e = level(h)
        out = [None] * m
        for k in range(h):
            o = torch.zeros_like(c[..., 0])
            for v in range(1, m, 2):
                o = o + int(t[s * v, k]) * c[..., s * v]
            out[k] = e[k] + o
            out[m - 1 - k] = e[k] - o
        return out

    return torch.stack(level(n), -1)


def _dst_forward_line(a: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    return torch.stack([sum(int(t[u, k]) * a[..., k] for k in range(4))
                        for u in range(4)], -1)


def _dst_inverse_line(c: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    return torch.stack([sum(int(t[u, k]) * c[..., u] for u in range(4))
                        for k in range(4)], -1)


def _two_passes(x: torch.Tensor, use_dst: bool, line) -> torch.Tensor:
    n = x.shape[-1]
    t = np.asarray(transform_matrix(n, use_dst), np.int64)
    shift = n.bit_length() - 1 + 5
    rnd = 1 << (shift - 1)
    v = x.to(torch.int32).transpose(-1, -2)      # lane i holds column i
    v = (line(v, t) + rnd) >> shift
    v = v.transpose(-1, -2)                      # lane i holds row i
    return ((line(v, t) + rnd) >> shift).contiguous()


def forward_2d(x: torch.Tensor, use_dst: bool) -> torch.Tensor:
    """(nb, N, N) int32 residuals -> coefficients, as the kernels do."""
    return _two_passes(x, use_dst,
                       _dst_forward_line if use_dst else _forward_line)


def inverse_2d(d: torch.Tensor, use_dst: bool) -> torch.Tensor:
    """(nb, N, N) int32 coefficients -> residuals, as the kernels do."""
    return _two_passes(d, use_dst,
                       _dst_inverse_line if use_dst else _inverse_line)


def _residuals(n: int, bit_depth: int, pattern: str, seed: int) -> np.ndarray:
    peak = (1 << bit_depth) - 1
    if pattern == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(-peak, peak + 1, (24, n, n)).astype(np.int32)
    yy, xx = np.mgrid[0:n, 0:n]
    if pattern == "checker":
        board = np.where((yy + xx) % 2 == 0, peak, -peak)
        return np.stack([board, -board, np.where(board > 0, peak, 0)]).astype(np.int32)
    # constant blocks at both extremes
    return np.stack([np.full((n, n), peak), np.full((n, n), -peak)]).astype(np.int32)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    arr = got.numpy()
    assert arr.dtype == want.dtype == np.int32
    assert arr.shape == want.shape
    assert np.array_equal(arr, want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_dct_even_odd_symmetry(n):
    """The property the butterflies rely on: at every level M = N, N/2,
    ..., 2 (S = N/M), T[S*v][M-1-k] = (-1)^v T[S*v][k] for k < M."""
    t = np.asarray(transform_matrix(n), np.int64)
    m = n
    while m >= 2:
        s = n // m
        for v in range(m):
            row = t[s * v, :m]
            assert np.array_equal(row[::-1], (-1) ** v * row), (n, m, v)
        m //= 2


def test_dst_has_no_even_odd_symmetry():
    """Why the DST-VII stays a 4x4 product in the kernels."""
    t = np.asarray(transform_matrix(4, True), np.int64)
    assert not any(np.array_equal(t[v, ::-1], (-1) ** v * t[v])
                   for v in range(4))


@pytest.mark.parametrize("pattern", ["random", "checker", "constant"])
@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
@pytest.mark.parametrize("n,use_dst", SIZES)
def test_forward_matches_both_packages(n, use_dst, bit_depth, pattern):
    x = _residuals(n, bit_depth, pattern, seed=100 * n + bit_depth)
    got = forward_2d(torch.from_numpy(x), use_dst)
    _same(got, tops.forward_transform(torch.from_numpy(x), use_dst).numpy())
    _same(got, jops.forward_transform(jnp.asarray(x), use_dst))


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("qp", [0, 51])
@pytest.mark.parametrize("bit_depth", BIT_DEPTHS)
@pytest.mark.parametrize("n,use_dst", SIZES)
def test_inverse_of_dequantized_levels_matches_both_packages(
        n, use_dst, bit_depth, qp, rescale):
    """The levels of the three residual patterns at this QP, and, since
    QP 51 zeroes most of them, 8 blocks of small random levels (+-4)."""
    x = np.concatenate([_residuals(n, bit_depth, p, seed=7 * n + bit_depth)
                        for p in ("random", "checker", "constant")])
    coeffs = tops.forward_transform(torch.from_numpy(x), use_dst)
    small = np.random.default_rng(n + qp).integers(-4, 5, (8, n, n))
    levels = torch.cat([tops.quantize(coeffs, qp, n),
                        torch.from_numpy(small.astype(np.int32))])
    deq = tops.dequantize(levels, qp, n, rescale=rescale)
    assert deq.any()
    got = inverse_2d(deq, use_dst)
    _same(got, tops.inverse_transform(deq, use_dst).numpy())
    _same(got, jops.inverse_transform(jnp.asarray(deq.numpy()), use_dst))
