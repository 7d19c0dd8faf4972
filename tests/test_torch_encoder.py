"""The port's frame encoders vs the JAX package's, bit-exact.

Small seeded 4:2:0 frames go through `nanohevc_tpu.models.all_intra`
and `nanohevc_tpu_torch.models.all_intra` (device="cpu").  Recon,
scan-packed levels, modes, nnz and dtypes must be equal, and so must
the bytes each side's runtime writes from its output.  Each side gets
its own package's `EncoderConfig` and `Frame`.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.frame import Frame, Plane
from nanohevc_tpu.models import all_intra as jax_ai
from nanohevc_tpu.runtime import parse_bitstream
from nanohevc_tpu_torch import config as port_config
from nanohevc_tpu_torch import frame as port_frame_mod
from nanohevc_tpu_torch import resolve_device
from nanohevc_tpu_torch.cli import assemble_frame_bitstream
from nanohevc_tpu_torch.models import all_intra as torch_ai


def port_cfg(cfg):
    """The port's EncoderConfig with the fields of JAX's `cfg`."""
    return port_config.EncoderConfig(**dataclasses.asdict(cfg))


def port_frame(frame):
    """The port's Frame holding the planes of JAX's `frame`."""
    return port_frame_mod.Frame(*(port_frame_mod.Plane(p.data)
                                  for p in (frame.y, frame.u, frame.v)))


def torch_frame_full(frame, cfg, device="cpu"):
    return torch_ai.encode_frame_full(port_frame(frame), port_cfg(cfg),
                                      device=device)


def make_frame(h, w, seed, bit_depth=8):
    """Textured seeded 4:2:0 frame: smooth ramps plus noise, so both DC
    and planar win some blocks."""
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1

    def plane(ph, pw):
        yy, xx = np.mgrid[0:ph, 0:pw]
        ramp = (yy * 3 + xx * 2) % (peak + 1)
        noise = rng.integers(-12, 13, (ph, pw))
        return Plane(np.clip(ramp + noise, 0, peak).astype(np.int16))

    return Frame(plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2))


@lru_cache(maxsize=None)
def _encoded(h, w, seed, cfg):
    frame = make_frame(h, w, seed, cfg.bit_depth)
    return (frame, jax_ai.encode_frame_full(frame, cfg),
            torch_frame_full(frame, cfg))


def _jax_frame_xla(frame, cfg):
    """JAX `encode_frame_full` with every plane on its XLA path.

    JAX routes mode_set="all"/decision="satd" planes to the Pallas
    mode-search kernels, which run through the slow CPU interpreter
    here; this assembles the same frame from the XLA formulation the
    kernels are held to (jax_ai._jit_full), as encode_frame_full does.
    """
    from nanohevc_tpu.ref.metrics import psnr, ssim

    recon = Frame.zeros(frame.height, frame.width, dtype=np.int16)
    info = {"planes": {}, "blocks": 0}
    for name, src, dst in (("Y", frame.y, recon.y), ("U", frame.u, recon.u),
                           ("V", frame.v, recon.v)):
        is_luma = name == "Y"
        bs = cfg.block_size if is_luma else cfg.chroma_block_size()
        fn = jax_ai._jit_full(
            bs, cfg.mode_set if is_luma else cfg.chroma_modes(), cfg.decision,
            cfg.use_dst(bs, is_luma), cfg.is_intra, cfg.bit_depth, cfg.scan,
            cfg.rdo_cbf, cfg.dequant_rescale, cfg.intra_smoothing and is_luma,
            cfg.rdoq,
        )
        out = fn(jnp.asarray(src.data), jnp.int32(cfg.qp))
        dst.data[...] = np.asarray(out["recon"]).astype(np.int16)
        info["planes"][name] = {
            "levels": np.asarray(out["levels"]),
            "modes": np.asarray(out["modes"]),
            "nnz": int(np.asarray(out["nnz"]).sum()),
            "block_size": bs,
        }
        info["blocks"] += int(out["modes"].shape[0])
    orig_y = frame.y.data.astype(np.uint8)
    rec_y = recon.y.data.astype(np.uint8)
    info["psnr_y"] = psnr(orig_y, rec_y)
    info["ssim_y"] = ssim(orig_y, rec_y)
    return recon, info


@lru_cache(maxsize=None)
def _encoded_xla(h, w, seed, cfg):
    frame = make_frame(h, w, seed, cfg.bit_depth)
    return (frame, _jax_frame_xla(frame, cfg), torch_frame_full(frame, cfg))


def _assert_same(jax_res, torch_res):
    (jr, ji), (tr, ti) = jax_res, torch_res
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(jr, p).data, getattr(tr, p).data), p
        assert getattr(jr, p).data.dtype == getattr(tr, p).data.dtype
    assert ji["blocks"] == ti["blocks"]
    for name in ("Y", "U", "V"):
        jp, tp = ji["planes"][name], ti["planes"][name]
        assert jp["block_size"] == tp["block_size"]
        assert jp["nnz"] == tp["nnz"]
        assert isinstance(tp["nnz"], int)
        for k in ("levels", "modes"):
            assert jp[k].dtype == tp[k].dtype, (name, k)
            assert jp[k].shape == tp[k].shape, (name, k)
            assert np.array_equal(jp[k], tp[k]), (name, k)
    assert ji["psnr_y"] == ti["psnr_y"]
    assert ji["ssim_y"] == ti["ssim_y"]


@pytest.mark.parametrize("shape", [(40, 64), (48, 96)])
@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_default_decision_matches_jax(shape, bs):
    cfg = EncoderConfig(block_size=bs, qp=22)
    _, j, t = _encoded(*shape, bs, cfg)
    _assert_same(j, t)


@pytest.mark.parametrize("decision", ["sad", "satd"])
@pytest.mark.parametrize("bs", [4, 8])
def test_other_decisions_match_jax(decision, bs):
    cfg = EncoderConfig(block_size=bs, qp=37, decision=decision)
    _, j, t = _encoded(40, 64, 7, cfg)
    _assert_same(j, t)


@pytest.mark.parametrize("bs", [8, 16])
def test_dequant_rescale_matches_jax(bs):
    cfg = EncoderConfig(block_size=bs, qp=37, dequant_rescale=True)
    _, j, t = _encoded(48, 96, 11, cfg)
    _assert_same(j, t)


@pytest.mark.parametrize("chroma", ["dc", "planar"])
def test_fixed_chroma_mode_matches_jax(chroma):
    """Fixed chroma modes take the plain path (no search) in both."""
    cfg = EncoderConfig(block_size=8, qp=30, chroma_mode_set=chroma)
    _, j, t = _encoded(40, 64, 19, cfg)
    _assert_same(j, t)


def test_mode_scan_and_10bit_match_jax():
    cfg = EncoderConfig(block_size=4, qp=30, scan="mode", bit_depth=10)
    _, j, t = _encoded(40, 64, 13, cfg)
    _assert_same(j, t)


def test_unaligned_width_takes_plain_path(monkeypatch):
    """W % N != 0 goes to the plain formulation, as in JAX."""
    calls = []
    real = torch_ai.slab_encode_plane

    def spy(plane, qp, n, **kw):
        calls.append((tuple(plane.shape), n))
        return real(plane, qp, n, **kw)

    monkeypatch.setattr(torch_ai, "slab_encode_plane", spy)
    cfg = EncoderConfig(block_size=16, qp=22)
    frame = make_frame(40, 72, 17)
    _assert_same(jax_ai.encode_frame_full(frame, cfg),
                 torch_frame_full(frame, cfg))
    assert calls == []                       # 72 % 16 and 36 % 8 != 0

    frame = make_frame(40, 64, 17)
    torch_frame_full(frame, cfg)
    assert calls == [((40, 64), 16), ((20, 32), 8), ((20, 32), 8)]


@pytest.mark.parametrize("bs", [8, 16])
def test_bitstream_bytes_match_jax(bs):
    cfg = EncoderConfig(block_size=bs, qp=22)
    frame, (_, ji), (_, ti) = _encoded(48, 96, bs, cfg)
    want = assemble_frame_bitstream(96, 48, port_cfg(cfg), ji)
    got = assemble_frame_bitstream(96, 48, port_cfg(cfg), ti)
    assert got == want
    parsed = parse_bitstream(got)
    for name in ("Y", "U", "V"):
        assert np.array_equal(parsed[name]["levels"], ti["planes"][name]["levels"])
        assert np.array_equal(parsed[name]["modes"], ti["planes"][name]["modes"])


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_encode_frame_intra_matches_jax(bs, tmp_path):
    frame = make_frame(40, 64, 23)
    jr, js = jax_ai.encode_frame_intra(frame, bs, str(tmp_path / "j.yuv"))
    tr, ts = torch_ai.encode_frame_intra(port_frame(frame), bs,
                                         str(tmp_path / "t.yuv"), device="cpu")
    assert js == ts
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(jr, p).data, getattr(tr, p).data)
    assert (tmp_path / "j.yuv").read_bytes() == (tmp_path / "t.yuv").read_bytes()


def test_create_test_frame_matches_jax():
    j = jax_ai.create_test_frame(36, 50)
    t = torch_ai.create_test_frame(36, 50)
    assert j.to_yuv420p() == t.to_yuv420p()


MODE_SEARCH = dict(mode_set="all", decision="satd")


@pytest.mark.parametrize("shape", [(40, 64), (48, 96)])
@pytest.mark.parametrize("bs", [4, 8, 16, 32])
def test_mode_search_matches_jax(shape, bs):
    cfg = EncoderConfig(block_size=bs, qp=22, **MODE_SEARCH)
    _, j, t = _encoded_xla(*shape, 50 + bs, cfg)
    _assert_same(j, t)


@pytest.mark.parametrize("kw", [
    dict(block_size=4, bit_depth=10),
    dict(block_size=16, dequant_rescale=True, qp=32),
    dict(block_size=8, scan="mode", qp=30),
    dict(block_size=8, qp=0),
    dict(block_size=16, qp=51),
], ids=["10bit", "rescale", "mode_scan", "qp0", "qp51"])
def test_mode_search_variants_match_jax(kw):
    cfg = EncoderConfig(**kw, **MODE_SEARCH)
    _, j, t = _encoded_xla(40, 64, 61, cfg)
    _assert_same(j, t)


@pytest.mark.parametrize("shape", [(40, 72), (37, 64)])
def test_mode_search_plain_route_matches_jax(shape):
    """W % N != 0 (plain path) and a partial height (kernel path)."""
    cfg = EncoderConfig(block_size=16, qp=27, **MODE_SEARCH)
    _, j, t = _encoded_xla(*shape, 62, cfg)
    _assert_same(j, t)


@pytest.mark.parametrize("decision", ["energy", "sad"])
@pytest.mark.parametrize("smoothing", [False, True])
@pytest.mark.parametrize("bs", [8, 16])
def test_mode_search_other_decisions_match_jax(decision, smoothing, bs):
    """These configs take the XLA path in JAX and the plain path here."""
    cfg = EncoderConfig(block_size=bs, qp=30, mode_set="all",
                        decision=decision, intra_smoothing=smoothing)
    _, j, t = _encoded(40, 64, 63, cfg)
    _assert_same(j, t)


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_intra_smoothing_matches_jax(bs):
    cfg = EncoderConfig(block_size=bs, qp=30, intra_smoothing=True)
    _, j, t = _encoded(48, 96, 64, cfg)
    _assert_same(j, t)


def test_mode_search_satd_smoothing_matches_jax():
    """Luma smoothing leaves the kernel for the plain path, chroma stays."""
    cfg = EncoderConfig(block_size=16, qp=30, intra_smoothing=True, **MODE_SEARCH)
    _, j, t = _encoded_xla(48, 96, 65, cfg)
    _assert_same(j, t)


@pytest.mark.parametrize("kw,width,want", [
    (MODE_SEARCH, 64, [((40, 64), 8), ((20, 32), 4), ((20, 32), 4)]),
    (dict(MODE_SEARCH, intra_smoothing=True), 64, [((20, 32), 4), ((20, 32), 4)]),
    (MODE_SEARCH | {"block_size": 16}, 72, []),
    (dict(mode_set="all", decision="sad"), 64, []),
])
def test_mode_search_routing(monkeypatch, kw, width, want):
    """Planes go to the mode-search kernel exactly where JAX sends them
    to its own, and never to the slab kernel."""
    calls = {"mode_search": [], "slab": []}
    for name, key in (("mode_search_encode_plane", "mode_search"),
                      ("slab_encode_plane", "slab")):
        real = getattr(torch_ai, name)

        def spy(plane, qp, n, _real=real, _key=key, **kw_):
            calls[_key].append((tuple(plane.shape), n))
            return _real(plane, qp, n, **kw_)

        monkeypatch.setattr(torch_ai, name, spy)
    cfg = EncoderConfig(qp=22, **kw)
    torch_frame_full(make_frame(40, width, 66), cfg)
    assert calls == {"mode_search": want, "slab": []}


@pytest.mark.parametrize("bs", [4, 8])
def test_mode_search_bitstream_bytes_match_jax(bs):
    cfg = EncoderConfig(block_size=bs, qp=22, **MODE_SEARCH)
    frame, (_, ji), (_, ti) = _encoded_xla(48, 96, 67, cfg)
    want = assemble_frame_bitstream(96, 48, port_cfg(cfg), ji)
    got = assemble_frame_bitstream(96, 48, port_cfg(cfg), ti)
    assert got == want
    parsed = parse_bitstream(got)
    for name in ("Y", "U", "V"):
        assert np.array_equal(parsed[name]["modes"], ti["planes"][name]["modes"])


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        torch_frame_full(make_frame(16, 16, 1), EncoderConfig(), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, MODE_SEARCH], ids=["dc_planar", "mode_search"])
def test_cuda_frame_matches_cpu(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine run "
                    "python -m pytest -m cuda tests/test_torch_*.py")
    cfg = EncoderConfig(block_size=8, qp=22, **kw)
    frame = make_frame(136, 240, 5)
    rc, ic = torch_frame_full(frame, cfg)
    rg, ig = torch_frame_full(frame, cfg, device="cuda")
    _assert_same((rc, ic), (rg, ig))
