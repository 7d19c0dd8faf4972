"""The port's public API vs the JAX package's.

Every name in the JAX package's `__all__` (top level, `ops`, `models`,
`parallel`, `utils`) is in the port's (`RENAMED` under its port name),
and each gives JAX's result on
the same seeded inputs: the reference API re-exported at the top level
(the numpy oracle `ref`, the frame model, `BlockView` /
`iterate_blocks`), the `models` pipelines (on the CPU), `ops.ssim` and
`utils.sample_parity_check`.

Tolerances: `ops.ssim` is a float32 mean over the SSIM map, which XLA's
CPU reduction and PyTorch sum in different orders; the values agree
within 1e-6 (absolute, on a value in [-1, 1]).  Everything else is
compared exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import nanohevc_tpu as jnh
import nanohevc_tpu.models as jmodels
import nanohevc_tpu.ops as jops
import nanohevc_tpu.parallel as jparallel
import nanohevc_tpu.utils as jutils
import nanohevc_tpu_torch as tnh
import nanohevc_tpu_torch.models as tmodels
import nanohevc_tpu_torch.ops as tops
import nanohevc_tpu_torch.parallel as tparallel
import nanohevc_tpu_torch.utils as tutils
from nanohevc_tpu.config import EncoderConfig as JaxConfig
from nanohevc_tpu_torch.config import EncoderConfig

SEED = 9
N = 8


# JAX names whose counterpart in the port has another name: the
# profiler region `trace_region`, which nothing called, became the port's
# stage span `span`.
RENAMED = {"trace_region": "span"}


@pytest.mark.parametrize("jmod, tmod", [
    (jnh, tnh), (jops, tops), (jmodels, tmodels), (jparallel, tparallel),
    (jutils, tutils)], ids=["top", "ops", "models", "parallel", "utils"])
def test_all_holds_every_jax_name(jmod, tmod):
    assert {RENAMED.get(n, n) for n in jmod.__all__} <= set(tmod.__all__)
    for name in tmod.__all__:
        assert hasattr(tmod, name), name


def _inputs():
    """Seeded int16 blocks and references, the same for both packages."""
    rng = np.random.default_rng(SEED)
    return dict(
        blk=rng.integers(0, 256, (N, N)).astype(np.int16),
        blk4=rng.integers(0, 256, (4, 4)).astype(np.int16),
        top=rng.integers(0, 256, 2 * N + 1).astype(np.int16),
        left=rng.integers(0, 256, 2 * N + 1).astype(np.int16),
        res=rng.integers(-255, 256, (N, N)).astype(np.int32),
        res4=rng.integers(-255, 256, (4, 4)).astype(np.int32),
        res16=rng.integers(-255, 256, (16, 16)).astype(np.int32),
        res32=rng.integers(-255, 256, (32, 32)).astype(np.int32),
        coeff=rng.integers(-4000, 4000, (N, N)).astype(np.int32),
        wide=rng.integers(-600, 900, (N, N)).astype(np.int32),
        plane=rng.integers(0, 256, (24, 40)).astype(np.int16),
        yuv=rng.integers(0, 256, 16 * 32 * 3 // 2, dtype=np.uint8).tobytes(),
    )


def _pool(m, x):
    pool = m.FrameBufferPool(16, 32, pool_size=2)
    i, buf = pool.acquire()
    j, _ = pool.acquire()
    pool.release(i)
    with pytest.raises(RuntimeError):
        pool.acquire()
        pool.acquire()
    return (i, j, buf.to_yuv420p(), pool.available_count, pool.in_use_count,
            pool.pool_size)


def _blocks(m, x):
    """Every BlockView of a plane: position, pixels and neighbours."""
    plane = m.Plane(x["plane"].copy())
    out = []
    for bv in m.iterate_blocks(plane, N):
        out.append((repr(bv), bv.shape, bv.copy_pixels(),
                    bv.get_top_neighbors(), bv.get_left_neighbors(),
                    bv.get_top_neighbors(2 * N if bv.x + 2 * N <= 40 else N),
                    bv.get_top_left_neighbor()))
    first = m.BlockView(plane, N, N, N)
    first.write_pixels(np.full((N, N), 7, np.int16))
    return out, plane.data


# One call per exported name, on the inputs of `_inputs`.
CALLS = {
    "Plane": lambda m, x: (repr(m.Plane(x["plane"])),
                           m.Plane.from_buffer(x["yuv"][:512], 16, 32).data),
    "Frame": lambda m, x: m.Frame.from_yuv420p(x["yuv"], 16, 32).to_yuv420p(),
    "PackedFrame": lambda m, x: m.PackedFrame.from_frame(
        m.Frame.from_yuv420p(x["yuv"], 16, 32)).to_frame().to_yuv420p(),
    "FrameBufferPool": _pool,
    "BlockView": lambda m, x: _blocks(m, x)[1],
    "iterate_blocks": lambda m, x: _blocks(m, x)[0],
    "INTRA_PRED_ANGLE": lambda m, x: m.INTRA_PRED_ANGLE,
    "intra_dc_predict_4x4": lambda m, x: m.intra_dc_predict_4x4(
        x["top"][1:5], x["left"][1:5]),
    "intra_dc_predict": lambda m, x: m.intra_dc_predict(
        x["top"][1:N + 1], x["left"][1:N + 1], N),
    "intra_planar_predict": lambda m, x: m.intra_planar_predict(
        x["top"][1:N + 1], x["left"][1:N + 1], int(x["top"][N + 1]),
        int(x["left"][N + 1]), N),
    "intra_angular_predict": lambda m, x: [
        m.intra_angular_predict(x["top"], x["left"], int(x["top"][0]), mode, N)
        for mode in range(2, 35)],
    "residual_block": lambda m, x: m.residual_block(x["blk"], x["blk"][::-1]),
    "reconstruct_block": lambda m, x: m.reconstruct_block(x["blk"], x["res"]),
    "clip_to_pixel_range": lambda m, x: (m.clip_to_pixel_range(x["wide"]),
                                         m.clip_to_pixel_range(x["wide"], 10)),
    "forward_transform": lambda m, x: (m.forward_transform(x["res"]),
                                       m.forward_transform(x["res4"], True)),
    "inverse_transform": lambda m, x: (m.inverse_transform(x["coeff"]),
                                       m.inverse_transform(x["res4"], True)),
    "forward_transform_4x4": lambda m, x: m.forward_transform_4x4(x["res4"]),
    "inverse_transform_4x4": lambda m, x: m.inverse_transform_4x4(x["res4"], True),
    "forward_transform_8x8": lambda m, x: m.forward_transform_8x8(x["res"]),
    "inverse_transform_8x8": lambda m, x: m.inverse_transform_8x8(x["coeff"]),
    "forward_transform_16x16": lambda m, x: m.forward_transform_16x16(x["res16"]),
    "inverse_transform_16x16": lambda m, x: m.inverse_transform_16x16(x["res16"]),
    "forward_transform_32x32": lambda m, x: m.forward_transform_32x32(x["res32"]),
    "inverse_transform_32x32": lambda m, x: m.inverse_transform_32x32(x["res32"]),
    "DCT4": lambda m, x: m.DCT4,
    "DCT8": lambda m, x: m.DCT8,
    "DCT16": lambda m, x: m.DCT16,
    "DCT32": lambda m, x: m.DCT32,
    "DST4": lambda m, x: m.DST4,
    "quantize": lambda m, x: [m.quantize(x["coeff"], qp, N, intra)
                              for qp in (0, 22, 51) for intra in (True, False)],
    "dequantize": lambda m, x: [m.dequantize(x["res"], qp, N, rescale)
                                for qp in (0, 22, 51) for rescale in (False, True)],
    "quantize_block": lambda m, x: m.quantize_block(x["coeff"], 30, False),
    "dequantize_block": lambda m, x: m.dequantize_block(x["res"], 30),
    "QUANT_SCALE": lambda m, x: m.QUANT_SCALE,
    "DEQUANT_SCALE": lambda m, x: m.DEQUANT_SCALE,
    "psnr": lambda m, x: (m.psnr(x["blk"], x["blk"][::-1]), m.psnr(x["blk"], x["blk"])),
    "mse": lambda m, x: m.mse(x["blk"], x["blk"][::-1]),
    "sad": lambda m, x: m.sad(x["blk"], x["blk"][::-1]),
    "satd_4x4": lambda m, x: m.satd_4x4(x["blk4"], x["blk4"].T),
    "residual_energy": lambda m, x: m.residual_energy(x["res"]),
}


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(p, q) for p, q in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def test_every_top_level_name_is_called():
    assert set(CALLS) == set(jnh.__all__)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_top_level_name_gives_jax_result(name):
    assert getattr(tnh, name) is not getattr(jnh, name)
    assert _same(CALLS[name](jnh, _inputs()), CALLS[name](tnh, _inputs()))


def _plane(h, w, seed=SEED):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.int32)


def test_models_encode_plane_parity():
    p = _plane(40, 48)
    jr, jd = jmodels.encode_plane_parity(jnp.asarray(p), N)
    tr, td = tmodels.encode_plane_parity(torch.from_numpy(p), N)
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert np.array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("cfg", [
    dict(), dict(mode_set="all", decision="satd"), dict(rdo_cbf=True)],
    ids=["default", "search", "rdo_cbf"])
def test_models_encode_plane_full(cfg):
    p = _plane(40, 48)
    j = jmodels.encode_plane_full(jnp.asarray(p), jnp.int32(27), n=N, **cfg)
    t = tmodels.encode_plane_full(torch.from_numpy(p), 27, n=N, **cfg)
    assert set(t) == set(j)
    for k in j:
        assert np.array_equal(np.asarray(j[k]), t[k].numpy()), k


def test_models_frame_encoders():
    jf = jmodels.create_test_frame(32, 48)
    tf = tmodels.create_test_frame(32, 48)
    assert jf.to_yuv420p() == tf.to_yuv420p()
    (jr, js), (tr, ts) = (jmodels.encode_frame_intra(jf, 8),
                          tmodels.encode_frame_intra(tf, 8, device="cpu"))
    assert jr.to_yuv420p() == tr.to_yuv420p() and js == ts
    (jr, ji), (tr, ti) = (jmodels.encode_frame_full(jf, JaxConfig()),
                          tmodels.encode_frame_full(tf, EncoderConfig(),
                                                    device="cpu"))
    assert jr.to_yuv420p() == tr.to_yuv420p()
    assert (ji["psnr_y"], ji["ssim_y"]) == (ti["psnr_y"], ti["ssim_y"])


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_ops_ssim(bit_depth):
    peak = (1 << bit_depth) - 1
    rng = np.random.default_rng(SEED + bit_depth)
    a = rng.integers(0, peak + 1, (45, 70)).astype(np.int32)
    b = np.clip(a + rng.integers(-peak // 12, peak // 12 + 1, a.shape), 0, peak
                ).astype(np.int32)
    for x, y in ((a, b), (a, a), (b, np.full_like(b, peak // 2))):
        want = float(jops.ssim(jnp.asarray(x), jnp.asarray(y), peak=peak))
        got = tops.ssim(torch.from_numpy(x), torch.from_numpy(y), peak=peak)
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6, (float(got), want)


def _jax_ssim_map(x, y, peak, window=8):
    """The map under `nanohevc_tpu.ops.ssim`'s mean, rebuilt from its
    expression."""
    import jax

    x, y = x.astype(jnp.float32), y.astype(jnp.float32)

    def box(a):
        s = jax.lax.reduce_window(a, 0.0, jax.lax.add, (window, window),
                                  (1, 1), "VALID")
        return s / (window * window)

    mx, my = box(x), box(y)
    mxx, myy, mxy = box(x * x), box(y * y), box(x * y)
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2))
    # the rebuilt map is the op's: its mean is the op's value
    np.testing.assert_allclose(float(jnp.mean(s)),
                               float(jops.ssim(x, y, peak=peak)), rtol=0,
                               atol=0)
    return np.asarray(s)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_ops_ssim_map_bit_exact(bit_depth):
    """The per-box SSIM map before the mean: equal bit for bit, at 10
    bits too, where the x*x box sums pass 2^24."""
    from nanohevc_tpu_torch.ops.metrics import _ssim_map

    peak = (1 << bit_depth) - 1
    rng = np.random.default_rng(SEED + bit_depth)
    a = rng.integers(0, peak + 1, (45, 70)).astype(np.int32)
    b = np.clip(a + rng.integers(-peak // 12, peak // 12 + 1, a.shape), 0, peak
                ).astype(np.int32)
    if bit_depth == 10:
        assert 64 * int(a.max()) ** 2 >= 1 << 24
    for x, y in ((a, b), (a, a), (b, np.full_like(b, peak // 2))):
        want = _jax_ssim_map(jnp.asarray(x), jnp.asarray(y), peak)
        got = _ssim_map(torch.from_numpy(x).float(), torch.from_numpy(y).float(),
                        peak, 8)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_parity_check_on_port_output():
    from nanohevc_tpu_torch.kernels.slab_pipeline import slab_encode_plane

    p = _plane(64, 96)
    out = slab_encode_plane(torch.from_numpy(p), 22, N)
    levels, recon = out["levels"].numpy().copy(), out["recon"].numpy()
    for check in (jutils.sample_parity_check, tutils.sample_parity_check):
        assert check(p, levels, recon, N, 22, samples=96) == 0
    # corrupt one level of a block that is sampled with every block
    levels[5, 0, 0] += 1
    for check in (jutils.sample_parity_check, tutils.sample_parity_check):
        assert check(p, levels, recon, N, 22, samples=96) == 1
