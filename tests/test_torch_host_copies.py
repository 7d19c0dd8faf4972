"""The port's copies of the host modules are still the originals.

`nanohevc_tpu_torch` keeps its own copies of `tables`, `config`,
`frame`, `block`, `utils/checks`, `ref` (the deblocking oracle
included), `runtime` (the standard-stream writer `hevc_stream`
included) and `ops/rate_tables` of `nanohevc_tpu`, so that it imports
nothing of the JAX package.  Each copy is held to its
original: the
source text (apart from the header line, the import lines, paths into
the upstream reference project, which the copies give from its root,
and, for the native runtime's build, where the libraries go), and the
results of the public functions on seeded inputs.  The port's tracing
spans (`with span(...)` blocks of `utils.tracing`, and their import)
are one addition a copy may make: with them taken out and their
bodies dedented, the text is the original's.  The other is a function
changed by design, named in `CHANGED` and in the copy's header line: it
is taken out of both texts, and held to its original by the bytes it
writes instead (`test_bitstream_bytes_and_parse_equal`).
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
    "ref/metrics.py", "ref/sao.py", "ref/deblock.py",
    "runtime/__init__.py", "runtime/entropy.py", "runtime/bitstream.py",
    "runtime/hevc_stream.py",
    "runtime/native/nanohevc_runtime.cpp", "runtime/native/hevc_cabac.cpp",
    "ops/rate_tables.py", "block.py", "utils/checks.py",
]
# Copies whose native-library build moved out of the source tree.
BUILD_COPIES = ["runtime/build.py", "runtime/hevc.py"]
# Functions a copy changes by design.  The copy's CABAC branch of
# `assemble_bitstream` hands the coder the scan-packed levels as they
# come, which `residual_encode` reads through the block's layout from
# the new entry `nhc_encode_plane_scan`; the original unpacks them to
# raster first.  The copy's `write_sao_ctb_params` codes the CTB SAO
# tiles with array operations where the original walks them one by one
# (held to it case by case in tests/test_torch_sao_ctb_writer.py).
CHANGED = {
    "runtime/bitstream.py": ("assemble_bitstream", "write_sao_ctb_params"),
    "runtime/native/hevc_cabac.cpp": ("residual_encode",
                                      "nhc_encode_plane_scan"),
}


def _code(text: str) -> list:
    """Source lines with the package name of imports made neutral and
    paths into the upstream reference given from its root."""
    return [re.sub(r"\bnanohevc_tpu_torch\b", "nanohevc_tpu",
                   re.sub(r"(?<![\w/])/\w+/reference/", "reference/", line))
            for line in text.splitlines()]


_SPAN_IMPORT = re.compile(
    r"^from nanohevc_tpu_torch\.utils\.tracing import (count, )?span$")
_SPAN_BLOCK = re.compile(r'^( *)with span\("[\w.]+"\):(  +#.*)?$')


def _without_spans(text: str) -> str:
    """The copy with its tracing spans taken out: the import of `span`
    dropped, and each `with span("..."):` line dropped with its block
    dedented by one level."""
    out, blocks = [], []          # blocks: indents of the open span lines
    for line in text.splitlines():
        indent = len(line) - len(line.lstrip(" "))
        while blocks and line.strip() and indent <= blocks[-1]:
            blocks.pop()
        m = _SPAN_BLOCK.match(line)
        if m:
            blocks.append(len(m.group(1)))
            continue
        if _SPAN_IMPORT.match(line):
            continue
        out.append(line[4 * len(blocks):] if line.strip() else line)
    return "\n".join(out)


def test_without_spans_restores_the_original_text():
    copy = ('from nanohevc_tpu_torch.utils.tracing import span\n'
            'def f(x):\n'
            '    with span("a.b"):\n'
            '        y = g(x)\n'
            '\n'
            '        with span("a.c"):\n'
            '            y = h(y)\n'
            '    return y\n')
    assert _without_spans(copy) == ('def f(x):\n'
                                    '    y = g(x)\n'
                                    '\n'
                                    '    y = h(y)\n'
                                    '    return y')
    # Anything else a copy adds still differs from its original.
    assert _without_spans(copy.replace("h(y)", "k(y)")) != _without_spans(copy)


def _without_functions(text: str, names) -> str:
    """The text with each top-level function of `names` taken out: its
    definition, the comment and `template` lines right above it, and its
    body (Python: up to the next unindented line other than the
    signature's closing parenthesis; C++: up to the closing brace at the
    start of a line, and one blank line after)."""
    lines, out, i = text.splitlines(), [], 0
    head = re.compile(r"^(def |\w[\w:<>*& ]* )(%s)\(" % "|".join(names))
    while i < len(lines):
        if not head.match(lines[i]):
            out.append(lines[i])
            i += 1
            continue
        while out and re.match(r"^(#|//|template |@)", out[-1]):
            out.pop()
        i += 1
        if lines[i - 1].startswith("def "):
            while i < len(lines) and (not lines[i] or lines[i][0] in " )"):
                i += 1
        else:
            while lines[i] != "}":
                i += 1
            i += 1 + (i + 1 < len(lines) and not lines[i + 1])
    return "\n".join(out)


@pytest.mark.parametrize("lang", ["py", "cpp"])
def test_without_functions_drops_the_named_functions_only(lang):
    if lang == "py":
        orig = ('import a\n\n\ndef f(\n    x,\n) -> int:\n    return g(x)\n\n\n'
                'def h(x):\n    f(x)\n    return x\n')
        copy = orig.replace("g(x)", "k(x)").replace(
            "def h", "def f2(y):\n    return y\n\n\ndef h")
        kept = 'import a\n\n\ndef h(x):\n    f(x)\n    return x'
    else:
        # g calls f, indented as every call inside a body is: the call
        # is not a definition, and g stays whole.
        orig = ('int g(int x) {\n  f(&x, 1);\n  return x;\n}\n\n'
                'void f(int* p,\n       int n) {\n  p[0] = n;\n}\n\n'
                'int h() { return 0; }\n')
        copy = orig.replace("p[0]", "p[n]").replace(
            "void f", "// why\ntemplate <bool kB = false>\nvoid f").replace(
            "int h", "int f2(int y) {\n  return y;\n}\n\nint h")
        kept = ('int g(int x) {\n  f(&x, 1);\n  return x;\n}\n\n'
                'int h() { return 0; }')
    names = ("f", "f2")
    assert _without_functions(orig, names) == kept
    assert _without_functions(copy, names) == kept
    # A change outside the named functions still shows.
    assert _without_functions(copy.replace("return x", "return -x"),
                              names) != kept
    assert _without_functions(copy, ("f",)) != kept


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_imports(rel):
    orig = (REPO / "nanohevc_tpu" / rel).read_text()
    copy = (REPO / "nanohevc_tpu_torch" / rel).read_text()
    changed = CHANGED.get(rel, ())
    if rel.endswith(".py"):
        header, _, copy = copy.partition("\n")
        assert header.startswith(f"# Copy of nanohevc_tpu/{rel} (only the "
                                 "import lines")
        assert all(f"`{name}`" in header for name in changed)
        copy = _without_spans(copy)
    if changed:
        orig = _without_functions(orig, changed)
        copy = _without_functions(copy, changed)
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


# --- ops/rate_tables -------------------------------------------------------

@pytest.mark.parametrize("ncoef", [16, 64, 256, 1024])
def test_rate_tables_equal(ncoef):
    from nanohevc_tpu.ops.rate_tables import DEFAULT_TABLES as want
    from nanohevc_tpu_torch.ops.rate_tables import DEFAULT_TABLES as got

    assert sorted(got) == sorted(want)
    assert dataclasses.asdict(got[ncoef]) == dataclasses.asdict(want[ncoef])


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


@pytest.mark.parametrize("is_chroma", [False, True], ids=["luma", "chroma"])
def test_ref_deblock_equal(is_chroma):
    import nanohevc_tpu.ref.deblock as j_deblock
    import nanohevc_tpu_torch.ref.deblock as t_deblock

    rng = np.random.default_rng(4 + is_chroma)
    plane = np.kron(rng.integers(40, 200, (5, 6)), np.ones((8, 8), int))
    plane = (plane + rng.integers(-3, 4, plane.shape)).astype(np.int32)
    assert np.array_equal(t_deblock.BETA_TABLE, j_deblock.BETA_TABLE)
    assert np.array_equal(t_deblock.TC_TABLE, j_deblock.TC_TABLE)
    for qp in (18, 37, 51):
        assert np.array_equal(
            t_deblock.deblock_plane(plane, qp, 8, is_chroma),
            j_deblock.deblock_plane(plane, qp, 8, is_chroma))


# --- runtime ----------------------------------------------------------------

def _planes(n_y, rng, with_modes, hw=(32, 48), density=0.3, peak=3):
    """Y at N = n_y and U/V at max(4, N/2) of an h x w frame, levels in
    [-peak, peak] with the given share nonzero at most."""
    levels, modes = {}, {}
    h, w = hw
    for name, (ph, pw), n in (("Y", (h, w), n_y),
                              ("U", (h // 2, w // 2), max(4, n_y // 2)),
                              ("V", (h // 2, w // 2), max(4, n_y // 2))):
        nb = (ph // n) * (pw // n)
        lv = (rng.integers(-peak, peak + 1, (nb, n * n))
              * (rng.random((nb, n * n)) < density))
        levels[name] = (lv.astype(np.int32), n)
        modes[name] = rng.integers(0, 35, nb).astype(np.int32)
    return levels, (modes if with_modes else None)


def _sao_ctb(rng, hw, tile):
    """CTB SAO maps of every plane at `tile`, runs of equal parameters
    included so that both merge flags are written."""
    out = {}
    for name, (ph, pw) in (("Y", hw), ("U", (hw[0] // 2, hw[1] // 2)),
                           ("V", (hw[0] // 2, hw[1] // 2))):
        nty, ntx = -(-ph // tile), -(-pw // tile)
        tmap = rng.integers(0, 6, (nty, ntx))
        bmap = rng.integers(0, 32, (nty, ntx))
        omap = rng.integers(-7, 8, (nty, ntx, 4))
        for ty, tx in itertools.product(range(nty), range(ntx)):
            r = rng.random()
            src = ((ty, tx - 1) if tx and r < 0.3 else
                   (ty - 1, tx) if ty and r < 0.6 else None)
            if src:
                for m in (tmap, bmap, omap):
                    m[ty, tx] = m[src]
        out[name] = (tile, tmap, bmap, omap)
    return out


BITSTREAM_CASES = [
    dict(entropy_coder=e, with_modes=m, scan=s, n=n)
    for e, m, s, n in (
        ("range", False, "diag", 8), ("range", True, "diag", 8),
        ("range", True, "mode", 4), ("cabac", False, "diag", 8),
        ("cabac", True, "mode", 8), ("cabac", True, "horizontal", 16),
        ("hevc-slice", True, "diag", 8), ("hevc-slice", True, "mode", 4),
    )
] + [
    # The benchmark's two configurations: mode scan, CABAC, deblocking,
    # CTB SAO at 64, Y at N=8 with U/V at N=4, and Y at N=4.
    dict(entropy_coder="cabac", with_modes=True, scan="mode", n=n,
         hw=(128, 192), sao_tile=64)
    for n in (8, 4)
] + [
    # Every fixed scan at the sizes with more than one sub-block row.
    dict(entropy_coder="cabac", with_modes=True, scan=s, n=n, hw=(64, 96))
    for s, n in (("diag", 16), ("vertical", 16), ("diag", 32),
                 ("horizontal", 32), ("vertical", 32))
] + [
    # No level at all; and levels up to int16's range, so that the
    # remaining levels escape to exp-Golomb and the Rice parameter rises.
    dict(entropy_coder="cabac", with_modes=True, scan="mode", n=8,
         hw=(64, 96), density=0.0),
    dict(entropy_coder="cabac", with_modes=True, scan="mode", n=8,
         hw=(64, 96), density=0.6, peak=32767),
] + [
    # The options of `assemble_bitstream` outside its CABAC branch:
    # per-frame SAO, the range coder on two tiles, and 10-bit samples
    # (the SPS and the CTB SAO offsets' width).
    dict(entropy_coder="cabac", with_modes=True, scan="mode", n=8,
         sao_frame=True),
    dict(entropy_coder="range", with_modes=True, scan="diag", n=8,
         hw=(64, 96), tiles=2),
    dict(entropy_coder="cabac", with_modes=True, scan="mode", n=8,
         hw=(128, 192), sao_tile=64, bit_depth=10),
]


@pytest.mark.parametrize("case", BITSTREAM_CASES,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_bitstream_bytes_and_parse_equal(case):
    rng = np.random.default_rng(len(str(case)))
    hw = case.get("hw", (32, 48))
    levels, modes = _planes(case["n"], rng, case["with_modes"], hw,
                            case.get("density", 0.3), case.get("peak", 3))
    kw = dict(bit_depth=case.get("bit_depth", 8), scan=case["scan"],
              entropy_coder=case["entropy_coder"],
              dequant_rescale=case["n"] == 16, intra_smoothing=case["n"] == 4,
              entropy_tiles=case.get("tiles", 1))
    if case.get("sao_frame"):
        kw["sao"] = {name: (int(rng.integers(0, 6)), int(rng.integers(0, 32)),
                            rng.integers(-7, 8, 4).astype(np.int32))
                     for name in "YUV"}
    if "sao_tile" in case:
        kw.update(dequant_rescale=True, intra_smoothing=True, deblock=True,
                  sao_ctb=_sao_ctb(rng, hw, case["sao_tile"]))
    want = j_bits.assemble_bitstream(hw[1], hw[0], 27, levels, modes, **kw)
    got = t_bits.assemble_bitstream(hw[1], hw[0], 27, levels, modes, **kw)
    assert got == want
    jp, tp = j_bits.parse_bitstream(want), t_bits.parse_bitstream(got)
    assert jp.keys() == tp.keys()
    for key in jp:
        assert jp[key].keys() == tp[key].keys()
        for k, v in jp[key].items():
            assert _same(tp[key][k], v), (key, k)


def _same(a, b) -> bool:
    """Equal values, with arrays, and tuples and dicts of them, compared
    element by element."""
    if isinstance(b, dict):
        return (isinstance(a, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in b))
    if isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and np.array_equal(a, b)
    if isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(map(_same, a, b)))
    return a == b


@pytest.mark.parametrize("chroma420", [False, True], ids=["mono", "420"])
def test_hevc_stream_bytes_equal(chroma420):
    import nanohevc_tpu.runtime.hevc_stream as j_hs
    import nanohevc_tpu_torch.runtime.hevc_stream as t_hs

    rng = np.random.default_rng(8 + chroma420)
    n, h, w = 8, 16, 32
    nb = (h // n) * (w // n)

    def levels(count, size):
        lv = rng.integers(-3, 4, (count, size, size))
        return (lv * (rng.random(lv.shape) < 0.2)).astype(np.int32)

    ly, my = levels(nb, n), rng.integers(0, 35, nb).astype(np.int32)
    lu, lv, mc = levels(nb, n // 2), levels(nb, n // 2), np.ones(nb, np.int32)
    streams = []
    for mod in (j_hs, t_hs):
        writer = mod.HevcStreamWriter(h, w, n, 30, chroma420=chroma420)
        for qp in (30, 33):
            if chroma420:
                writer.add_frame(ly, my, lu, lv, mc, qp=qp)
            else:
                writer.add_frame(ly, my, qp=qp)
        streams.append(writer.bytes())
    assert streams[1] == streams[0] and len(streams[0]) > 0


# --- models/rate_control ----------------------------------------------------

def _rate_control_code(text: str) -> list:
    """Source lines with the device keyword the copy threads through to
    the port's encoders taken out."""
    return [re.sub(r', device=("cuda"|device)', "", line) for line in _code(text)]


def test_rate_control_copy_differs_only_in_imports_and_device():
    rel = "models/rate_control.py"
    orig = (REPO / "nanohevc_tpu" / rel).read_text()
    header, _, copy = (REPO / "nanohevc_tpu_torch" / rel).read_text().partition("\n")
    assert header.startswith(f"# Copy of nanohevc_tpu/{rel} (only the import "
                             "lines and the device")
    assert _rate_control_code(copy) == _code(orig)


@pytest.mark.parametrize("closed_loop", [False, True], ids=["open", "closed"])
def test_find_frame_qp_equal(closed_loop):
    import nanohevc_tpu.models.rate_control as j_rc
    import nanohevc_tpu_torch.models.rate_control as t_rc

    rng = np.random.default_rng(17)
    planes = [(rng.integers(0, 256, s) // 4 + 96).astype(np.int16)
              for s in ((32, 32), (16, 16), (16, 16))]
    budget = 420
    want = j_rc.find_frame_qp(j_frame.Frame(*map(j_frame.Plane, planes)),
                              j_config.EncoderConfig(), budget,
                              closed_loop=closed_loop)
    got = t_rc.find_frame_qp(t_frame.Frame(*map(t_frame.Plane, planes)),
                             t_config.EncoderConfig(), budget,
                             closed_loop=closed_loop, device="cpu")
    assert got == want
    assert 0 < got[0] < 51 and got[1] <= budget


def test_rate_controller_equal():
    import nanohevc_tpu.models.rate_control as j_rc
    import nanohevc_tpu_torch.models.rate_control as t_rc

    rng = np.random.default_rng(2)
    j = j_rc.RateController(target_bits=8e4, qp=30)
    t = t_rc.RateController(target_bits=8e4, qp=30)
    for bits in rng.integers(1, 4e5, 24):
        assert t.update(float(bits)) == j.update(float(bits))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
