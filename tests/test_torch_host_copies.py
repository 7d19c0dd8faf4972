"""The port's copies of the host modules are still the originals.

`nanohevc_tpu_torch` keeps its own copies of `tables`, `config`,
`frame`, `ref` and `runtime` of `nanohevc_tpu`, so that it imports
nothing of the JAX package.  Each copy is held to its original: the
source text (apart from the header line, the import lines, paths into
the upstream reference project, which the copies give from its root,
and, for the native runtime's build, where the libraries go), and the
results of the public functions on seeded inputs.
"""

import dataclasses
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

import nanohevc_tpu.config as j_config
import nanohevc_tpu.frame as j_frame
import nanohevc_tpu.ref as j_ref
import nanohevc_tpu.ref.metrics as j_metrics
import nanohevc_tpu.ref.sao as j_sao
import nanohevc_tpu.runtime.bitstream as j_bits
import nanohevc_tpu.tables as j_tables
import nanohevc_tpu_torch.config as t_config
import nanohevc_tpu_torch.frame as t_frame
import nanohevc_tpu_torch.ref as t_ref
import nanohevc_tpu_torch.ref.metrics as t_metrics
import nanohevc_tpu_torch.ref.sao as t_sao
import nanohevc_tpu_torch.runtime.bitstream as t_bits
import nanohevc_tpu_torch.tables as t_tables

REPO = Path(__file__).resolve().parent.parent
COPIES = [
    "tables.py", "config.py", "frame.py",
    "ref/__init__.py", "ref/intra.py", "ref/transform.py", "ref/quant.py",
    "ref/metrics.py", "ref/sao.py",
    "runtime/__init__.py", "runtime/entropy.py", "runtime/bitstream.py",
    "runtime/native/nanohevc_runtime.cpp", "runtime/native/hevc_cabac.cpp",
]
# Copies whose native-library build moved out of the source tree.
BUILD_COPIES = ["runtime/build.py", "runtime/hevc.py"]


def _code(text: str) -> list:
    """Source lines with the package name of imports made neutral and
    paths into the upstream reference given from its root."""
    return [re.sub(r"\bnanohevc_tpu_torch\b", "nanohevc_tpu",
                   re.sub(r"(?<![\w/])/\w+/reference/", "reference/", line))
            for line in text.splitlines()]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_imports(rel):
    orig = (REPO / "nanohevc_tpu" / rel).read_text()
    copy = (REPO / "nanohevc_tpu_torch" / rel).read_text()
    if rel.endswith(".py"):
        header, _, copy = copy.partition("\n")
        assert header.startswith(f"# Copy of nanohevc_tpu/{rel} (only the "
                                 "import lines")
    assert _code(copy) == _code(orig)


@pytest.mark.parametrize("rel", BUILD_COPIES)
def test_build_copies_name_their_original(rel):
    header = (REPO / "nanohevc_tpu_torch" / rel).read_text().splitlines()[0]
    assert header.startswith(f"# Copy of nanohevc_tpu/{rel}")


def test_native_runtime_builds_outside_the_sources():
    from nanohevc_tpu_torch.runtime import build, hevc

    for lib in (build.build_runtime(), hevc.build_hevc_runtime()):
        assert lib.parent == REPO / "build" / "nanohevc_tpu_torch" / "runtime"
        assert lib.exists()
    native = REPO / "nanohevc_tpu_torch" / "runtime" / "native"
    assert sorted(p.name for p in native.iterdir()) == [
        "hevc_cabac.cpp", "nanohevc_runtime.cpp"]


# --- tables -----------------------------------------------------------------

PUBLIC_TABLES = sorted(
    k for k, v in vars(j_tables).items()
    if not k.startswith("_") and isinstance(v, (np.ndarray, list, dict))
)


@pytest.mark.parametrize("name", PUBLIC_TABLES)
def test_tables_equal(name):
    want, got = getattr(j_tables, name), getattr(t_tables, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_table_functions_equal(n):
    for fn in ("diag_scan_order", "horizontal_scan_order",
               "vertical_scan_order"):
        assert np.array_equal(getattr(t_tables, fn)(n), getattr(j_tables, fn)(n))
    assert np.array_equal(t_tables.transform_matrix(n, False),
                          j_tables.transform_matrix(n, False))
    assert np.array_equal(t_tables.make_dct_matrix(n), j_tables.make_dct_matrix(n))
    if n == 4:
        assert np.array_equal(t_tables.transform_matrix(4, True),
                              j_tables.transform_matrix(4, True))
        assert np.array_equal(t_tables.make_dst4_matrix(),
                              j_tables.make_dst4_matrix())
    assert [t_tables.mode_angle(m) for m in range(2, 35)] == [
        j_tables.mode_angle(m) for m in range(2, 35)]


# --- config -----------------------------------------------------------------

def test_config_fields_and_defaults_equal():
    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert spec(t_config.EncoderConfig) == spec(j_config.EncoderConfig)


CONFIG_GRID = [
    dict(block_size=bs, mode_set=ms, chroma_mode_set=cm, is_intra=intra)
    for bs, ms, cm, intra in itertools.product(
        (4, 8, 16, 32), ("dc_planar", "all", "dc", "planar"),
        (None, "dc", "all"), (True, False))
]


@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_config_helpers_equal(bs):
    for kw in CONFIG_GRID:
        if kw["block_size"] != bs:
            continue
        j, t = j_config.EncoderConfig(**kw), t_config.EncoderConfig(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.chroma_block_size() == j.chroma_block_size()
        assert t.chroma_modes() == j.chroma_modes()
        for n, luma in itertools.product((4, 8, 16, 32), (True, False)):
            assert t.use_dst(n, luma) == j.use_dst(n, luma)


@pytest.mark.parametrize("bad", [
    dict(block_size=5), dict(mode_set="x"), dict(chroma_mode_set="x"),
    dict(decision="x"), dict(scan="x"), dict(entropy_coder="x"),
    dict(sao=True, sao_ctb=True), dict(sao_tile=48),
])
def test_config_rejects_the_same(bad):
    for cls in (j_config.EncoderConfig, t_config.EncoderConfig):
        with pytest.raises(ValueError):
            cls(**bad)


# --- frame ------------------------------------------------------------------

@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("shape", [(16, 24), (36, 50)])
def test_frame_yuv_bytes_equal(bit_depth, shape):
    h, w = shape
    rng = np.random.default_rng(h * w + bit_depth)
    peak = (1 << bit_depth) - 1
    planes = [rng.integers(0, peak + 1, s).astype(np.int16)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    j = j_frame.Frame(*(j_frame.Plane(p) for p in planes))
    t = t_frame.Frame(*(t_frame.Plane(p) for p in planes))
    assert t.to_yuv420p(bit_depth=bit_depth) == j.to_yuv420p(bit_depth=bit_depth)
    raw = j.to_yuv420p()
    jb = j_frame.Frame.from_yuv420p(raw, h, w)
    tb = t_frame.Frame.from_yuv420p(raw, h, w)
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(tb, p).data, getattr(jb, p).data)
        assert getattr(tb, p).data.dtype == getattr(jb, p).data.dtype
    assert (t_frame.PackedFrame.from_yuv420p(raw, h, w).to_yuv420p()
            == j_frame.PackedFrame.from_yuv420p(raw, h, w).to_yuv420p())


def test_frame_buffer_pool_equal():
    for mod in (j_frame, t_frame):
        pool = mod.FrameBufferPool(8, 8, pool_size=2)
        a, _ = pool.acquire()
        b, _ = pool.acquire()
        assert (pool.available_count, pool.in_use_count) == (0, 2)
        with pytest.raises(RuntimeError):
            pool.acquire()
        pool.release(a)
        with pytest.raises(ValueError):
            pool.release(a)
        pool.release(b)


# --- ref --------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_ref_intra_equal(n):
    rng = np.random.default_rng(n)
    top = rng.integers(0, 256, 2 * n + 1).astype(np.int32)
    left = rng.integers(0, 256, 2 * n + 1).astype(np.int32)
    t1, l1 = top[1:n + 1], left[1:n + 1]
    pairs = [
        (lambda r: r.intra_dc_predict(t1, l1, n)),
        (lambda r: r.intra_planar_predict(t1, l1, int(top[n]), int(left[n]), n)),
    ] + [
        (lambda r, m=m: r.intra_angular_predict(top, left, int(top[0]), m, n))
        for m in range(2, 35)
    ]
    for fn in pairs:
        assert np.array_equal(fn(t_ref), fn(j_ref))
    blk = rng.integers(0, 256, (n, n))
    pred = j_ref.intra_dc_predict(t1, l1, n)
    res = t_ref.residual_block(blk, pred)
    assert np.array_equal(res, j_ref.residual_block(blk, pred))
    assert np.array_equal(t_ref.reconstruct_block(pred, res),
                          j_ref.reconstruct_block(pred, res))
    assert np.array_equal(t_ref.clip_to_pixel_range(res * 9, 10),
                          j_ref.clip_to_pixel_range(res * 9, 10))


@pytest.mark.parametrize("n,dst", [(4, False), (4, True), (8, False),
                                   (16, False), (32, False)])
def test_ref_transform_and_quant_equal(n, dst):
    rng = np.random.default_rng(n + dst)
    res = rng.integers(-255, 256, (n, n)).astype(np.int32)
    coeff = t_ref.forward_transform(res, use_dst=dst)
    assert np.array_equal(coeff, j_ref.forward_transform(res, use_dst=dst))
    for qp in (0, 22, 37, 51):
        lvl = t_ref.quantize(coeff, qp, n)
        assert np.array_equal(lvl, j_ref.quantize(coeff, qp, n))
        deq = t_ref.dequantize(lvl, qp, n)
        assert np.array_equal(deq, j_ref.dequantize(lvl, qp, n))
        assert np.array_equal(t_ref.inverse_transform(deq, use_dst=dst),
                              j_ref.inverse_transform(deq, use_dst=dst))
        assert t_ref.get_qp_params(qp) == j_ref.get_qp_params(qp)
        assert t_ref.estimate_bits(lvl) == j_ref.estimate_bits(lvl)
        assert t_ref.count_nonzero(lvl) == j_ref.count_nonzero(lvl)


@pytest.mark.parametrize("shape", [(16, 16), (37, 53)])
def test_ref_metrics_equal(shape):
    rng = np.random.default_rng(shape[0])
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, shape), 0, 255).astype(np.uint8)
    for fn in ("mse", "psnr", "sad", "ssim"):
        assert getattr(t_metrics, fn)(a, b) == getattr(j_metrics, fn)(a, b), fn
    assert t_metrics.psnr(a, a) == j_metrics.psnr(a, a)
    assert t_metrics.satd_4x4(a[:4, :4], b[:4, :4]) == j_metrics.satd_4x4(
        a[:4, :4], b[:4, :4])
    assert t_metrics.residual_energy(a.astype(int) - b) == \
        j_metrics.residual_energy(a.astype(int) - b)
    for n in (4, 8, 16, 32):
        assert np.array_equal(t_metrics.hadamard_matrix(n),
                              j_metrics.hadamard_matrix(n))


def test_ref_sao_equal():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (24, 32))
    rec = np.clip(src + rng.integers(-6, 7, src.shape), 0, 255)
    for name in ("SAO_OFF", "SAO_BO", "SAO_EO0"):
        assert getattr(t_sao, name) == getattr(j_sao, name)
    (tt, tp, to), (jt, jp, jo) = (t_sao.estimate_sao(src, rec),
                                  j_sao.estimate_sao(src, rec))
    assert (tt, tp) == (jt, jp) and np.array_equal(to, jo)
    assert np.array_equal(t_sao.apply_sao(rec, jt, jp, jo),
                          j_sao.apply_sao(rec, jt, jp, jo))
    for eo in range(4):
        assert np.array_equal(t_sao.eo_categories(rec, eo),
                              j_sao.eo_categories(rec, eo))


# --- runtime ----------------------------------------------------------------

def _planes(n_y, rng, with_modes):
    """Y at N = n_y and U/V at max(4, N/2) of a 32x48 frame."""
    levels, modes = {}, {}
    for name, (h, w), n in (("Y", (32, 48), n_y),
                            ("U", (16, 24), max(4, n_y // 2)),
                            ("V", (16, 24), max(4, n_y // 2))):
        nb = (h // n) * (w // n)
        lv = rng.integers(-3, 4, (nb, n * n)) * (rng.random((nb, n * n)) < 0.3)
        levels[name] = (lv.astype(np.int32), n)
        modes[name] = rng.integers(0, 35, nb).astype(np.int32)
    return levels, (modes if with_modes else None)


BITSTREAM_CASES = [
    dict(entropy_coder=e, with_modes=m, scan=s, n=n)
    for e, m, s, n in (
        ("range", False, "diag", 8), ("range", True, "diag", 8),
        ("range", True, "mode", 4), ("cabac", False, "diag", 8),
        ("cabac", True, "mode", 8), ("cabac", True, "horizontal", 16),
        ("hevc-slice", True, "diag", 8), ("hevc-slice", True, "mode", 4),
    )
]


@pytest.mark.parametrize("case", BITSTREAM_CASES,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_bitstream_bytes_and_parse_equal(case):
    rng = np.random.default_rng(len(str(case)))
    levels, modes = _planes(case["n"], rng, case["with_modes"])
    kw = dict(bit_depth=8, scan=case["scan"], entropy_coder=case["entropy_coder"],
              dequant_rescale=case["n"] == 16, intra_smoothing=case["n"] == 4)
    want = j_bits.assemble_bitstream(48, 32, 27, levels, modes, **kw)
    got = t_bits.assemble_bitstream(48, 32, 27, levels, modes, **kw)
    assert got == want
    jp, tp = j_bits.parse_bitstream(want), t_bits.parse_bitstream(got)
    assert jp.keys() == tp.keys()
    for key in jp:
        assert jp[key].keys() == tp[key].keys()
        for k, v in jp[key].items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(tp[key][k], v), (key, k)
            else:
                assert tp[key][k] == v, (key, k)
