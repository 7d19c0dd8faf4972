"""The port's angular prediction, smoothing and 35-mode decision vs JAX.

The same seeded numpy planes go through `nanohevc_tpu` (ops and
`models.all_intra.decide_modes`) and `nanohevc_tpu_torch` (ops and
`ops.mode_decision.decide_modes`) on the CPU.
Tolerance zero: every output is an integer and must be equal, dtype
and shape included.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu import ops as jops
from nanohevc_tpu.models import all_intra as jax_ai
from nanohevc_tpu.ops import angular_tables as jax_tables
from nanohevc_tpu.ops import intra as jax_intra
from nanohevc_tpu_torch import ops as tops
from nanohevc_tpu_torch.ops import angular_tables as torch_tables
from nanohevc_tpu_torch.ops import mode_decision as torch_md

SIZES = [4, 8, 16, 32]


def _same(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _refs(seed, n, bit_depth=8, shape_mult=(3, 4)):
    """(plane, JAX refs, port refs) of a seeded plane."""
    rng = np.random.default_rng(seed)
    h, w = shape_mult[0] * n, shape_mult[1] * n
    x = rng.integers(0, 1 << bit_depth, (h, w)).astype(np.int32)
    boundary = 1 << (bit_depth - 1)
    return (x, jops.extract_refs(jnp.asarray(x), n, boundary=boundary),
            tops.extract_refs(torch.from_numpy(x), n, boundary=boundary))


def _modes(seed, nb):
    return np.random.default_rng(seed).integers(0, 35, nb).astype(np.int32)


class TestAngularTables:
    @pytest.mark.parametrize("n", SIZES)
    def test_tables_match_jax(self, n):
        j, t = jax_tables.angular_tables(n), torch_tables.angular_tables(n)
        assert j.modes == t.modes
        for k in ("src", "idx", "frac"):
            a, b = getattr(j, k), getattr(t, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k

    @pytest.mark.parametrize("n", SIZES)
    def test_weight_matrices_match_jax(self, n):
        a = jax_tables.angular_weight_matrices(n)
        b = torch_tables.angular_weight_matrices(n)
        assert a.dtype == b.dtype and np.array_equal(a, b)

    @pytest.mark.parametrize("modes", [(2,), (10, 26), (11, 18, 25, 34)])
    def test_mode_subsets_match_jax(self, modes):
        for n in (4, 8):
            j = jax_tables.angular_tables(n, modes)
            t = torch_tables.angular_tables(n, modes)
            for k in ("src", "idx", "frac"):
                assert np.array_equal(getattr(j, k), getattr(t, k)), (n, k)
            assert np.array_equal(jax_tables.angular_weight_matrices(n, modes),
                                  torch_tables.angular_weight_matrices(n, modes))


class TestAngularPredict:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_all_modes(self, n, bit_depth):
        _, jr, tr = _refs(10 + n, n, bit_depth)
        _same(jops.angular_predict_all(jr, n), tops.angular_predict_all(tr, n))

    @pytest.mark.parametrize("n", SIZES)
    def test_mode_subset(self, n):
        _, jr, tr = _refs(20 + n, n)
        modes = (2, 9, 18, 27, 34)
        _same(jops.angular_predict_modes(jr, n, modes),
              tops.angular_predict_modes(tr, n, modes))

    def test_all_equals_weight_matrix_form(self):
        """The gather form equals the JAX package's (refs @ W + 16) >> 5."""
        n = 8
        _, _, tr = _refs(31, n)
        w = torch.from_numpy(torch_tables.angular_weight_matrices(n)).long()
        mm = (torch.einsum("br,mrp->bmp", tr.long(), w) + 16) >> 5
        got = tops.angular_predict_all(tr, n).reshape(mm.shape)
        assert torch.equal(got.long(), mm)

    @pytest.mark.parametrize("n", SIZES)
    def test_predict_by_mode(self, n):
        _, jr, tr = _refs(40 + n, n)
        m = _modes(41 + n, tr.shape[0])
        _same(jax_intra.predict_by_mode(jr, n, jnp.asarray(m)),
              tops.predict_by_mode(tr, n, torch.from_numpy(m)))

    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("smoothing", [False, True])
    def test_predict_by_mode_mm(self, n, smoothing):
        _, jr, tr = _refs(50 + n, n)
        m = _modes(51 + n, tr.shape[0])
        m[:3] = (0, 1, 26)                        # planar, DC, pure vertical
        _same(jax_intra.predict_by_mode_mm(jr, n, jnp.asarray(m),
                                           smoothing=smoothing),
              tops.predict_by_mode_mm(tr, n, torch.from_numpy(m),
                                      smoothing=smoothing))


class TestSmoothing:
    @pytest.mark.parametrize("n", SIZES)
    def test_filter_flags(self, n):
        a = jax_intra.mode_filter_flags(n)
        b = tops.mode_filter_flags(n)
        assert a.dtype == b.dtype and np.array_equal(a, b)

    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_smooth_refs(self, n, bit_depth):
        _, jr, tr = _refs(60 + n, n, bit_depth)
        _same(jops.smooth_refs(jr, n, bit_depth), tops.smooth_refs(tr, n, bit_depth))
        _same(jax_intra.cat_refs(jr, n, bit_depth), tops.cat_refs(tr, n, bit_depth))

    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_strong_filter_32(self, bit_depth):
        """Linear ramps make both arms flat: the bilinear 32x32 filter
        must fire for interior blocks, and match JAX exactly."""
        n = 32
        yy, xx = np.mgrid[0:3 * n, 0:4 * n]
        x = (yy + 2 * xx).astype(np.int32) % (1 << bit_depth)
        jr = jops.extract_refs(jnp.asarray(x), n, boundary=1 << (bit_depth - 1))
        tr = tops.extract_refs(torch.from_numpy(x), n,
                               boundary=1 << (bit_depth - 1))
        strong = tops.smooth_refs(tr, n, bit_depth)
        weak = tops.smooth_refs(tr, n, bit_depth, strong=False)
        assert not torch.equal(strong, weak)
        _same(jops.smooth_refs(jr, n, bit_depth), strong)
        _same(jops.smooth_refs(jr, n, bit_depth, strong=False), weak)


class TestDecideModes:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("decision", ["energy", "sad", "satd"])
    @pytest.mark.parametrize("smoothing", [False, True])
    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_all_modes_match_jax(self, n, decision, smoothing, bit_depth):
        x, jr, tr = _refs(70 + n, n, bit_depth, shape_mult=(2, 3))
        jb = jops.tile_plane(jnp.asarray(x), n)
        tb = tops.tile_plane(torch.from_numpy(x), n)
        jp, jm = jax_ai.decide_modes(jb, jr, n, "all", decision,
                                     smoothing=smoothing, bit_depth=bit_depth)
        tp, tm = torch_md.decide_modes(tb, tr, n, "all", decision,
                                       smoothing=smoothing, bit_depth=bit_depth)
        _same(jm, tm)
        _same(jp, tp)

    @pytest.mark.parametrize("n", [8, 16, 32])
    @pytest.mark.parametrize("mode_set", ["dc_planar", "planar"])
    def test_smoothing_on_dc_planar(self, n, mode_set):
        x, jr, tr = _refs(80 + n, n)
        jb = jops.tile_plane(jnp.asarray(x), n)
        tb = tops.tile_plane(torch.from_numpy(x), n)
        jp, jm = jax_ai.decide_modes(jb, jr, n, mode_set, "satd", smoothing=True)
        tp, tm = torch_md.decide_modes(tb, tr, n, mode_set, "satd", smoothing=True)
        _same(jm, tm)
        _same(jp, tp)

    def test_ties_go_to_lowest_index(self):
        """A flat plane at the boundary fill ties every mode: "all" picks
        planar (0), while "dc_planar" picks DC (1)."""
        x = torch.full((16, 32), 128, dtype=torch.int32)
        refs = tops.extract_refs(x, 8)
        blocks = tops.tile_plane(x, 8)
        _, m_all = torch_md.decide_modes(blocks, refs, 8, "all", "satd")
        _, m_dp = torch_md.decide_modes(blocks, refs, 8, "dc_planar", "satd")
        assert m_all.eq(0).all() and m_dp.eq(1).all()

    def test_chunked_search_equals_one_chunk(self, monkeypatch):
        """The running minimum over mode chunks picks what one pass over
        all 33 angular modes picks, ties included."""
        x, _, tr = _refs(90, 8, shape_mult=(4, 5))
        x[:16, :16] = 128                          # some tied blocks
        tr = tops.extract_refs(torch.from_numpy(x), 8)
        tb = tops.tile_plane(torch.from_numpy(x), 8)
        whole = torch_md.decide_modes(tb, tr, 8, "all", "satd")
        monkeypatch.setattr(torch_md, "_SEARCH_CHUNK_ELEMS", 3 * tb.numel())
        chunked = torch_md.decide_modes(tb, tr, 8, "all", "satd")
        assert torch.equal(whole[0], chunked[0])
        assert torch.equal(whole[1], chunked[1])

    def test_rd_needs_qp(self):
        """As in JAX: decision="rd" without a QP raises ValueError."""
        x, _, tr = _refs(91, 8)
        tb = tops.tile_plane(torch.from_numpy(x), 8)
        with pytest.raises(ValueError, match="needs qp"):
            torch_md.decide_modes(tb, tr, 8, "all", "rd")
