"""PyTorch port ops vs the JAX ops, bit-exact (tolerance zero).

The same seeded numpy inputs go through `nanohevc_tpu.ops` and
`nanohevc_tpu_torch.ops` on the CPU; every integer output must be
equal, dtype included.  mse/psnr are float32 reductions in both
packages, compared with a relative tolerance of 1e-6 (summation order
differs; float32 carries ~7 digits).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu import ops as jops
from nanohevc_tpu.kernels.slab_pipeline import _qp_scalars
from nanohevc_tpu.ops.transform import _matrix as jax_matrix
from nanohevc_tpu.tables import DEQUANT_SCALE, QUANT_SCALE
from nanohevc_tpu_torch import ops as tops
from nanohevc_tpu_torch.params import encoder_tables, qp_scalars

SIZES = [4, 8, 16, 32]


def _same(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _plane(seed, shape, bit_depth=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bit_depth, shape).astype(np.int32)


class TestParams:
    @pytest.mark.parametrize("n,use_dst", [(4, False), (4, True), (8, False),
                                           (16, False), (32, False)])
    def test_transform_matrix(self, n, use_dst):
        t = encoder_tables(n, use_dst)["transform"]
        _same(jax_matrix(n, use_dst), t)

    def test_quant_tables(self):
        tabs = encoder_tables(8)
        assert tabs["quant_scale"].tolist() == list(QUANT_SCALE)
        assert tabs["dequant_scale"].tolist() == list(DEQUANT_SCALE)

    @pytest.mark.parametrize("n", SIZES)
    def test_scan_tables_are_inverse(self, n):
        tabs = encoder_tables(n)
        for kind in ("diag", "horizontal", "vertical"):
            fwd = tabs[f"scan_{kind}"].long()
            inv = tabs[f"scan_{kind}_inverse"].long()
            assert torch.equal(fwd[inv], torch.arange(n * n))

    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("bit_depth", [8, 10])
    @pytest.mark.parametrize("rescale", [False, True])
    def test_qp_scalars(self, n, bit_depth, rescale):
        for qp in (-3, 0, 5, 22, 37, 51, 60):
            want = np.asarray(_qp_scalars(qp, n, bit_depth, rescale)).ravel()
            got = qp_scalars(qp, n, bit_depth, rescale)
            assert list(got) == want.tolist(), qp


class TestTiling:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("shape_mult", [(2, 3), (2.5, 3.25)])
    def test_tile_untile(self, n, shape_mult):
        h, w = int(shape_mult[0] * n), int(shape_mult[1] * n)
        x = _plane(n, (h, w))
        _same(jops.tile_plane(jnp.asarray(x), n), tops.tile_plane(torch.from_numpy(x), n))
        blocks = jops.tile_plane(jnp.asarray(x), n)
        _same(
            jops.untile_plane(blocks, h, w, fill=7),
            tops.untile_plane(torch.from_numpy(np.array(blocks)), h, w, fill=7),
        )

    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_extract_refs(self, n, bit_depth):
        h, w = 3 * n + n // 2, 4 * n + (n // 4)      # partial edges both ways
        x = _plane(100 + n, (h, w), bit_depth)
        boundary = 1 << (bit_depth - 1)
        _same(
            jops.extract_refs(jnp.asarray(x), n, boundary=boundary),
            tops.extract_refs(torch.from_numpy(x), n, boundary=boundary),
        )


class TestIntra:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_dc_and_planar(self, n, bit_depth):
        x = _plane(200 + n, (3 * n, 4 * n), bit_depth)
        jrefs = jops.extract_refs(jnp.asarray(x), n)
        trefs = tops.extract_refs(torch.from_numpy(x), n)
        _same(jops.dc_predict(jrefs, n), tops.dc_predict(trefs, n))
        _same(jops.planar_predict(jrefs, n), tops.planar_predict(trefs, n))


class TestTransform:
    @pytest.mark.parametrize("n,use_dst", [(4, False), (4, True), (8, False),
                                           (16, False), (32, False)])
    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_forward_inverse(self, n, use_dst, bit_depth):
        rng = np.random.default_rng(300 + n + bit_depth)
        peak = (1 << bit_depth) - 1
        res = rng.integers(-peak, peak + 1, (6, n, n)).astype(np.int32)
        jc = jops.forward_transform(jnp.asarray(res), use_dst)
        tc = tops.forward_transform(torch.from_numpy(res), use_dst)
        _same(jc, tc)
        _same(jops.inverse_transform(jc, use_dst),
              tops.inverse_transform(tc, use_dst))


class TestQuant:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("qp", [0, 22, 37, 51])
    @pytest.mark.parametrize("rescale", [False, True])
    def test_quantize_dequantize(self, n, qp, rescale):
        rng = np.random.default_rng(400 + n + qp)
        coeff = rng.integers(-65000, 65001, (5, n, n)).astype(np.int32)
        for is_intra in (True, False):
            _same(jops.quantize(jnp.asarray(coeff), qp, n, is_intra),
                  tops.quantize(torch.from_numpy(coeff), qp, n, is_intra))
        lv = np.array(jops.quantize(jnp.asarray(coeff), qp, n, True))
        _same(jops.dequantize(jnp.asarray(lv), qp, n, rescale=rescale),
              tops.dequantize(torch.from_numpy(lv), qp, n, rescale=rescale))


class TestScan:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("kind", ["diag", "horizontal", "vertical", "mode"])
    def test_pack_unpack(self, n, kind):
        rng = np.random.default_rng(500 + n)
        lv = rng.integers(-40, 41, (35, n, n)).astype(np.int32)
        modes = np.arange(35, dtype=np.int32)
        jp = jops.scan_pack(jnp.asarray(lv), kind, modes=jnp.asarray(modes))
        tp = tops.scan_pack(torch.from_numpy(lv), kind, modes=torch.from_numpy(modes))
        _same(jp, tp)
        _same(jops.scan_unpack(jp, kind, modes=jnp.asarray(modes)),
              tops.scan_unpack(tp, kind, modes=torch.from_numpy(modes)))

    @pytest.mark.parametrize("n", SIZES)
    def test_mode_scan_idx(self, n):
        from nanohevc_tpu.ops.scan import mode_scan_idx as jax_idx

        modes = np.arange(35, dtype=np.int32)
        _same(jax_idx(jnp.asarray(modes), n),
              tops.mode_scan_idx(torch.from_numpy(modes), n))

    def test_mode_scan_needs_modes(self):
        with pytest.raises(ValueError):
            tops.scan_pack(torch.zeros((2, 4, 4), dtype=torch.int32), "mode")


class TestMetrics:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_block_costs(self, n, bit_depth):
        a = _plane(600 + n, (7, n, n), bit_depth)
        b = _plane(700 + n, (7, n, n), bit_depth)
        ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
        _same(jops.residual_energy_blocks(ja - jb), tops.residual_energy_blocks(ta - tb))
        _same(jops.sad_blocks(ja, jb), tops.sad_blocks(ta, tb))
        _same(jops.satd_blocks(ja, jb), tops.satd_blocks(ta, tb))

    def test_mse_psnr(self):
        a = _plane(800, (24, 40))
        b = _plane(801, (24, 40))
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        np.testing.assert_allclose(
            float(jops.mse(jnp.asarray(a), jnp.asarray(b))),
            float(tops.mse(ta, tb)), rtol=1e-6)
        np.testing.assert_allclose(
            float(jops.psnr(jnp.asarray(a), jnp.asarray(b))),
            float(tops.psnr(ta, tb)), rtol=1e-6)
        assert tops.psnr(ta, ta).item() == float("inf")
