"""The port's SAO (per-plane and CTB-granular) vs the JAX package's and
the numpy oracle, bit-exact.

Seeded (source, reconstruction) pairs go through `nanohevc_tpu.ops.sao`
/ `ops.sao_ctb` and `nanohevc_tpu_torch.ops.sao` / `ops.sao_ctb` on the
CPU: classification, application, the integer per-tile statistics and
the float32 RD choice (34 candidates, merge pass, lambda) must give the
same parameters and pixels.  The tolerance is 0.  The reconstructions
are the source blurred, biased and noised in a seeded mix, so that
every candidate family wins somewhere.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nanohevc_tpu.ops import sao as j_sao
from nanohevc_tpu.ops import sao_ctb as j_ctb
from nanohevc_tpu_torch.ops import sao as t_sao
from nanohevc_tpu_torch.ops import sao_ctb as t_ctb
from nanohevc_tpu_torch.ref import sao as oracle


def pair(h, w, bit_depth, seed):
    """(src, rec) int32 planes: smooth textured source; rec blurred
    along a seeded direction, shifted in a band of levels, noised."""
    rng = np.random.default_rng(seed)
    pix_max = (1 << bit_depth) - 1
    base = rng.integers(0, pix_max + 1, (h // 4 + 2, w // 4 + 2))
    src = np.kron(base, np.ones((4, 4), int))[:h, :w]
    src = np.clip(src + rng.integers(-6, 7, (h, w)) * (pix_max // 255),
                  0, pix_max)
    ax = int(rng.integers(0, 2))
    blur = (np.roll(src, 1, ax) + 2 * src + np.roll(src, -1, ax)) // 4
    rec = np.where(rng.random((h, w)) < 0.5 + 0.1 * (seed % 4), blur, src)
    shift = int(rng.integers(-4, 5)) * (pix_max // 255)
    band = (rec >> (bit_depth - 5)) % 8 == seed % 8
    rec = rec + np.where(band, shift, 0)
    rec = rec + rng.integers(-2, 3, (h, w)) * (pix_max // 255)
    return (src.astype(np.int32),
            np.clip(rec, 0, pix_max).astype(np.int32))


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))


# --- per-plane SAO ----------------------------------------------------------

@pytest.mark.parametrize("type_idx", range(6))
def test_apply_sao_types(type_idx):
    for bit_depth, shape in ((8, (24, 40)), (10, (17, 33))):
        _, rec = pair(*shape, bit_depth, type_idx)
        cap = oracle.max_offset(bit_depth)
        rng = np.random.default_rng(type_idx)
        offs = rng.integers(-cap, cap + 1, 4).astype(np.int32)
        pos = int(rng.integers(0, 32))            # 29-31 wrap past band 31
        got = t_sao.apply_sao(t(rec), type_idx, pos, offs, bit_depth).numpy()
        assert np.array_equal(got, np.asarray(j_sao.apply_sao(
            j(rec), type_idx, pos, offs, bit_depth)))
        assert np.array_equal(got, oracle.apply_sao(rec, type_idx, pos, offs,
                                                    bit_depth))


def test_apply_sao_batch_takes_each_planes_parameters():
    _, a = pair(16, 24, 8, 1)
    _, b = pair(16, 24, 8, 2)
    types, pos = np.array([2, 5], np.int32), np.array([0, 30], np.int32)
    offs = np.array([[3, 1, -1, -3], [2, -2, 4, -4]], np.int32)
    got = t_sao.apply_sao(t(np.stack([a, b])), t(types), t(pos), t(offs))
    for i, plane in enumerate((a, b)):
        assert np.array_equal(got[i].numpy(), oracle.apply_sao(
            plane, int(types[i]), int(pos[i]), offs[i]))


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("seed", range(6))
def test_estimate_sao(seed, bit_depth):
    src, rec = pair(48, 64, bit_depth, seed)
    got = t_sao.estimate_sao(t(src), t(rec), bit_depth)
    same(got, j_sao.estimate_sao(j(src), j(rec), bit_depth))
    want = oracle.estimate_sao(src, rec, bit_depth)
    assert (int(got[0]), int(got[1])) == (want[0], want[1])
    assert np.array_equal(got[2].numpy(), want[2])


def test_estimate_sao_batch_is_per_plane():
    pairs = [pair(32, 48, 8, s) for s in (3, 4)]
    got = t_sao.estimate_sao(t(np.stack([p[0] for p in pairs])),
                             t(np.stack([p[1] for p in pairs])))
    for i, (src, rec) in enumerate(pairs):
        same([g[i] for g in got], j_sao.estimate_sao(j(src), j(rec)))


def test_estimate_sao_picks_every_family():
    """Over the seeds the choice covers EO and BO (the tests above
    exercise more than one branch of the decision)."""
    kinds = {int(t_sao.estimate_sao(*map(t, pair(48, 64, 8, s)))[0])
             for s in range(6)}
    assert oracle.SAO_BO in kinds and kinds & {1, 2, 3, 4}


def test_first_argmin_takes_the_first_tie():
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, -0.0, 5.0, 0.0]])
    assert t_sao.first_argmin(x, 1).tolist() == [1, 0]
    assert t_sao.first_argmin(x.T.contiguous(), 0).tolist() == [1, 0]


# --- CTB-granular SAO --------------------------------------------------------

SHAPES = [(96, 128, 32), (72, 100, 64)]      # tests/test_sao_ctb.py's


@pytest.mark.parametrize("h,w,tile", SHAPES)
def test_sao_tile_stats(h, w, tile):
    for bit_depth in (8, 10):
        src, rec = pair(h, w, bit_depth, h + bit_depth)
        got = t_ctb.sao_tile_stats(t(src), t(rec), tile, bit_depth)
        want = j_ctb.sao_tile_stats(j(src), j(rec), tile, bit_depth)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("scale", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no-merge"])
@pytest.mark.parametrize("h,w,tile", SHAPES)
def test_estimate_sao_ctb(h, w, tile, merge, scale):
    src, rec = pair(h, w, 8, w + int(10 * scale))
    got = t_ctb.estimate_sao_ctb(t(src), t(rec), tile, 27, 8, scale, merge)
    same(got, j_ctb.estimate_sao_ctb(j(src), j(rec), tile, 27, 8, scale,
                                     merge))
    nty, ntx = j_ctb.tile_grid(h, w, tile)
    assert got[0].shape == (nty, ntx) and got[2].shape == (nty, ntx, 4)


def test_estimate_sao_ctb_10bit_batch():
    pairs = [pair(72, 100, 10, s) for s in (5, 6)]
    got = t_ctb.estimate_sao_ctb(t(np.stack([p[0] for p in pairs])),
                                 t(np.stack([p[1] for p in pairs])), 32, 37,
                                 10)
    for i, (src, rec) in enumerate(pairs):
        same([g[i] for g in got],
             j_ctb.estimate_sao_ctb(j(src), j(rec), 32, 37, 10))


@pytest.mark.parametrize("h,w,tile", SHAPES)
def test_apply_sao_ctb(h, w, tile):
    src, rec = pair(h, w, 8, tile)
    maps = j_ctb.estimate_sao_ctb(j(src), j(rec), tile, 22)
    kinds = set(np.asarray(maps[0]).ravel().tolist())
    rng = np.random.default_rng(tile)
    # Every type in some tile, band positions past 28 included.
    tm = rng.integers(0, 6, np.asarray(maps[0]).shape).astype(np.int32)
    bm = rng.integers(0, 32, tm.shape).astype(np.int32)
    om = rng.integers(-7, 8, tm.shape + (4,)).astype(np.int32)
    for m in (tuple(np.asarray(a) for a in maps), (tm, bm, om)):
        got = t_ctb.apply_sao_ctb(t(rec), *map(t, m), tile).numpy()
        assert np.array_equal(got, np.asarray(j_ctb.apply_sao_ctb(
            j(rec), *map(j, m), tile)))
    assert len(kinds) > 1


def test_ctb_lambda_is_jaxs_float32():
    """The CTB RD lambda, rd_lambda_scale * 0.57 * exp2((qp - 12) / 3)
    in JAX's float32 (sao_ctb.py there), over QP 0..51, eager and
    jitted, bit for bit (the port reads JAX's exp2 bits from a table;
    torch's exp2 differs at 28 of these QPs)."""
    from nanohevc_tpu_torch.ops.rate import _rd_lambda

    def lam(qp, scale):
        return scale * 0.57 * jnp.exp2((jnp.asarray(qp, jnp.float32) - 12.0)
                                       / 3.0)

    jitted = jax.jit(lam, static_argnums=1)
    for scale in (1.0, 0.1):
        got = np.array([_rd_lambda(q, scale) for q in range(52)], np.float32)
        for fn in (lam, jitted):
            want = np.array([np.asarray(fn(jnp.int32(q), scale))
                             for q in range(52)], np.float32)
            assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
