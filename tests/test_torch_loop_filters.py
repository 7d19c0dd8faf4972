"""The in-loop filters on the port's closed loop, its decoders and its
sequence runner vs the JAX package's, bit-exact.

Deblocking, per-frame SAO and CTB SAO (and deblocking with either) run
on every route of `encode_planes_closed_loop`: the wavefront kernel's
(its plain version on the CPU), the plain loop (reference smoothing),
RDOQ and `decision="rd"`.  Recon, levels, modes, SAO parameters, bytes
and decoded pixels must equal the JAX package's on the CPU, at an
aligned and a non-aligned geometry; the tolerance is 0.  Where the JAX
package would run its 35-mode SATD kernel through the slow CPU
interpreter, its XLA scan (`allow_fast=False`, pinned to that kernel by
its own tests) stands in.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import nanohevc_tpu.models.sequence as jax_seq
from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.frame import Frame, Plane
from nanohevc_tpu.models import wavefront as jax_wf
from nanohevc_tpu.runtime.entropy import CorruptBitstreamError as JaxCorrupt
from nanohevc_tpu_torch import config as port_config
from nanohevc_tpu_torch import frame as port_frame_mod
from nanohevc_tpu_torch.models import sequence as seq
from nanohevc_tpu_torch.models import wavefront as torch_wf
from nanohevc_tpu_torch.runtime import entropy
from nanohevc_tpu_torch.runtime.bitstream import _split_nals, parse_bitstream
from nanohevc_tpu_torch.runtime.entropy import CorruptBitstreamError


def make_frame(h, w, seed, bit_depth=8):
    """A ramp with 8x8 steps and noise: edges to deblock, offsets to
    find."""
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1

    def plane(ph, pw):
        yy, xx = np.mgrid[0:ph, 0:pw]
        steps = rng.integers(0, peak // 4, (ph // 8 + 1, pw // 8 + 1))
        ramp = (yy * 3 + xx * 2 + np.kron(steps, np.ones((8, 8), int))[
            :ph, :pw]) % (peak + 1)
        noise = rng.integers(-9, 10, (ph, pw)) << (bit_depth - 8)
        return Plane(np.clip(ramp + noise, 0, peak).astype(np.int16))

    return Frame(plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2))


def port_frame(frame):
    return port_frame_mod.Frame(*(port_frame_mod.Plane(p.data)
                                  for p in (frame.y, frame.u, frame.v)))


def port_cfg(cfg):
    return port_config.EncoderConfig(**dataclasses.asdict(cfg))


FILTERS = {
    "deblock": dict(deblock=True),
    "sao": dict(sao=True),
    "sao_ctb32": dict(sao_ctb=True, sao_tile=32),
    "deblock+sao": dict(deblock=True, sao=True),
    "deblock+sao_ctb": dict(deblock=True, sao_ctb=True),
}
# Each route of the closed loop, with the filters on.
ROUTES = {
    "kernel": dict(),
    "plain-loop": dict(intra_smoothing=True, qp=30),
    "rdoq": dict(rdoq=True, qp=27),
    "rd": dict(decision="rd", scan="mode", entropy_coder="cabac"),
}
# (filters, route): every filter on the kernel's route, and deblocking
# with SAO or CTB SAO on each other route, on a frame of a non-aligned
# geometry (the filters see the padded planes; the sequences below
# cover aligned ones).
SHAPE = (38, 50)
FRAME_CASES = [(f, "kernel") for f in FILTERS] + [
    ("deblock+sao_ctb", "plain-loop"), ("deblock+sao", "rdoq"),
    ("deblock+sao_ctb", "rd")]
FRAME_IDS = [f"{f}-{r}" for f, r in FRAME_CASES]
# The cases whose stream JAX's own decoder decodes too.
JAX_DECODED = {("sao_ctb32", "kernel"), ("deblock+sao", "rdoq"),
               ("deblock+sao_ctb", "plain-loop")}


@lru_cache(maxsize=None)
def _frame_codec(filt, route, h, w):
    cfg = EncoderConfig(**FILTERS[filt], **ROUTES[route])
    frame = make_frame(h, w, len(filt) + len(route))
    jr, jb = jax_wf.encode_frame_closed_loop(frame, cfg)
    tr, tb = torch_wf.encode_frame_closed_loop(port_frame(frame),
                                               port_cfg(cfg), device="cpu")
    return jr, jb, tr, tb


def _same_frames(a, b):
    return all(np.array_equal(getattr(a, p).data, getattr(b, p).data)
               for p in ("y", "u", "v"))


@pytest.mark.parametrize("filt,route", FRAME_CASES, ids=FRAME_IDS)
def test_encode_frame_equals_jax(filt, route):
    """Recon and bytes (levels, modes and the SAO NAL's parameters) of
    encode_frame_closed_loop, and the SAO parameters in the stream."""
    jr, jb, tr, tb = _frame_codec(filt, route, *SHAPE)
    assert tb == jb
    assert _same_frames(tr, jr)
    params = parse_bitstream(tb)["params"]
    assert params.get("deblock", False) == FILTERS[filt].get("deblock", False)
    kind = "sao_ctb" if "sao_ctb" in filt else "sao" if "sao" in filt else None
    if kind:
        assert params[kind].keys() == {"Y", "U", "V"}


@pytest.mark.parametrize("filt,route", FRAME_CASES, ids=FRAME_IDS)
def test_decode_frame_equals_recon_and_jax(filt, route):
    """decode_frame gives the recon (which equals JAX's), and JAX's own
    decode of the stream on three of the cases."""
    jr, jb, tr, tb = _frame_codec(filt, route, *SHAPE)
    got = torch_wf.decode_frame(tb, device="cpu")
    assert _same_frames(got, tr)
    if (filt, route) in JAX_DECODED:
        assert _same_frames(got, jax_wf.decode_frame(jb))


def test_filters_change_the_recon():
    """The filters act: each filtered recon differs from the unfiltered
    one, while levels and modes stay those of the unfiltered encode."""
    frame = port_frame(make_frame(*SHAPE, 3))
    plain, plain_bits = torch_wf.encode_frame_closed_loop(
        frame, port_config.EncoderConfig(), device="cpu")
    want = parse_bitstream(plain_bits)
    for filt in FILTERS:
        rec, bits = torch_wf.encode_frame_closed_loop(
            frame, port_config.EncoderConfig(**FILTERS[filt]), device="cpu")
        assert not np.array_equal(rec.y.data, plain.y.data), filt
        got = parse_bitstream(bits)
        for name in ("Y", "U", "V"):
            assert np.array_equal(got[name]["levels"], want[name]["levels"])
            assert np.array_equal(got[name]["modes"], want[name]["modes"])


# --- the plane API: batches, per-frame parameters, the 35-mode search --------

def _jax_planes(planes, qp, **kw):
    out = jax_wf.encode_planes_closed_loop(jnp.asarray(planes), jnp.int32(qp),
                                           allow_fast=False, **kw)
    return {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v) for k, v in out.items()}


def _assert_outputs_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        for gi, wi in (zip(g, w) if isinstance(w, tuple) else ((g, w),)):
            assert gi.dtype == torch.int32, k
            assert np.array_equal(gi.numpy(), wi), k


PLANE_CASES = {
    "search+deblock+sao_ctb": (dict(mode_set="all", decision="satd",
                                    deblock=True, sao_ctb=True, sao_tile=16),
                               8, 8),
}


@pytest.mark.parametrize("name", PLANE_CASES)
def test_planes_batch_of_two_equals_jax(name):
    """(2, H, W) planes of a non-aligned geometry through
    encode_planes_closed_loop: recon, levels, modes and the per-frame
    "sao" / "sao_ctb" outputs."""
    kw, n, bit_depth = PLANE_CASES[name]
    rng = np.random.default_rng(len(name))
    f = [make_frame(*SHAPE, s, bit_depth).y.data for s in rng.integers(0, 99, 2)]
    planes = np.stack(f).astype(np.int32)
    qp = 33
    got = torch_wf.encode_planes_closed_loop(
        torch.from_numpy(planes), qp, n=n, bit_depth=bit_depth, **kw)
    _assert_outputs_equal(got, _jax_planes(planes, qp, n=n,
                                           bit_depth=bit_depth, **kw))


def test_sao_and_sao_ctb_are_exclusive():
    planes = torch.zeros((1, 16, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        torch_wf.encode_planes_closed_loop(planes, 22, n=8, sao=True,
                                           sao_ctb=True)


@pytest.mark.parametrize("kind", ["sao", "sao_ctb"])
def test_decode_planes_per_frame_qp_and_sao(kind):
    """Two frames coded at different QPs with their own SAO parameters
    decode in one decode_planes call, each to its recon and to JAX's
    decode."""
    qps = [24, 38]
    tile = 16
    kw = dict(n=8, deblock=True, **{kind: True})
    if kind == "sao_ctb":
        kw["sao_tile"] = tile
    outs = [torch_wf.encode_planes_closed_loop(
        torch.from_numpy(make_frame(*SHAPE, 40 + i).y.data.astype(np.int32))[None],
        q, **kw) for i, q in enumerate(qps)]
    levels = torch.cat([o["levels"] for o in outs])
    modes = torch.cat([o["modes"] for o in outs])
    params = tuple(torch.cat(p) for p in zip(*(o[kind] for o in outs)))
    if kind == "sao_ctb":
        params = (tile,) + params
    dec_kw = dict(n=8, height=SHAPE[0], width=SHAPE[1], deblock=True,
                  **{kind: params})
    got = torch_wf.decode_planes(levels, modes, qps, **dec_kw)
    for i, o in enumerate(outs):
        assert np.array_equal(got[i].numpy(), o["recon"][0].numpy())
    jparams = tuple(np.asarray(p) if isinstance(p, torch.Tensor) else p
                    for p in params)
    want = jax_wf.decode_planes(
        jnp.asarray(levels.numpy()), jnp.asarray(modes.numpy()),
        jnp.asarray(qps, jnp.int32), **{**dec_kw, kind: jparams})
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_decode_frame_without_its_sao_nal_raises():
    _, _, _, bits = _frame_codec("deblock+sao", "kernel", *SHAPE)
    kept = b"".join(entropy.wrap_nal(t, p) for t, p in _split_nals(bits)
                    if t != entropy.NAL_SAO)
    with pytest.raises(JaxCorrupt, match="SAO NAL is missing"):
        jax_wf.decode_frame(kept)
    with pytest.raises(CorruptBitstreamError, match="SAO NAL is missing"):
        torch_wf.decode_frame(kept, device="cpu")


# --- sequences ---------------------------------------------------------------

def write_sequence(path, width, height, frames, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, frames * width * height * 3 // 2, dtype=np.uint8)
    path.write_bytes((data // 4 + 96).astype(np.uint8).tobytes())


SEQ_CASES = {
    "deblock+sao_ctb, resumed": (dict(deblock=True, sao_ctb=True,
                                      sao_tile=32), dict()),
    "deblock+sao, target_bpp": (dict(deblock=True, sao=True),
                                dict(target_bpp=1.5)),
}


@pytest.mark.parametrize("name", SEQ_CASES)
def test_sequence_bytes_and_decode_equal_jax(tmp_path, name):
    """3 frames, then resumed to 5, at batch 2 (a ragged tail): bytes,
    sidecar and decoded YUV equal JAX's; the decode is the recon of
    each frame's single-frame encode at the slice QP."""
    cfg, kw = SEQ_CASES[name]
    src = tmp_path / "seq.yuv"
    write_sequence(src, 48, 32, 5, seed=len(name))
    runs = []
    for tag, mod, config, extra in (
            ("jax", jax_seq, EncoderConfig(**cfg), {}),
            ("port", seq, port_config.EncoderConfig(**cfg), {"device": "cpu"})):
        bits, dec = tmp_path / f"{tag}.bin", tmp_path / f"{tag}.yuv"
        for frames in (3, 5):
            res = mod.encode_sequence(str(src), 48, 32, frames, config,
                                      str(bits), batch=2, closed_loop=True,
                                      **kw, **extra)
        assert (res.frames, res.resumed_from) == (5, 3)
        assert mod.decode_sequence(str(bits), str(dec), **extra) == 5
        runs.append((bits.read_bytes(),
                     (tmp_path / f"{tag}.bin.progress").read_text(),
                     dec.read_bytes()))
    assert runs[1] == runs[0]
    raw, fs = src.read_bytes(), 48 * 32 * 3 // 2
    qps = [fr["Y"].get("qp") for fr in seq.decode_sequence_levels(
        str(tmp_path / "port.bin"))]
    for i in (0, 4):
        frame = port_frame_mod.Frame.from_yuv420p(raw[i * fs:(i + 1) * fs],
                                                  32, 48)
        config = port_config.EncoderConfig(**{**cfg, "qp": qps[i] or 22})
        recon, _ = torch_wf.encode_frame_closed_loop(frame, config,
                                                     device="cpu")
        assert runs[1][2][i * fs:(i + 1) * fs] == recon.to_yuv420p()


def test_sequence_decode_without_a_frames_sao_nal_raises(tmp_path):
    src = tmp_path / "seq.yuv"
    write_sequence(src, 32, 32, 2, seed=4)
    bits = tmp_path / "s.bin"
    seq.encode_sequence(str(src), 32, 32, 2,
                        port_config.EncoderConfig(sao_ctb=True), str(bits),
                        batch=2, closed_loop=True, device="cpu")
    nals = _split_nals(bits.read_bytes())
    drop = [i for i, (t, _) in enumerate(nals) if t == entropy.NAL_SAO][1]
    cut = tmp_path / "cut.bin"
    cut.write_bytes(b"".join(entropy.wrap_nal(t, p)
                             for i, (t, p) in enumerate(nals) if i != drop))
    with pytest.raises(JaxCorrupt, match="frame 1 has no SAO NAL"):
        jax_seq.decode_sequence(str(cut), str(tmp_path / "j.yuv"))
    with pytest.raises(CorruptBitstreamError, match="frame 1 has no SAO NAL"):
        seq.decode_sequence(str(cut), str(tmp_path / "t.yuv"), device="cpu")


def test_sequence_decode_fills_frames_without_parameters(tmp_path):
    """A chunk where only some frames carry SAO parameters (the SAO
    flag off in the parameter sets) decodes the others with identity
    parameters, as JAX does."""
    src = tmp_path / "seq.yuv"
    write_sequence(src, 32, 32, 2, seed=6)
    bits = tmp_path / "s.bin"
    seq.encode_sequence(str(src), 32, 32, 2, port_config.EncoderConfig(sao=True),
                        str(bits), batch=2, closed_loop=True, device="cpu")
    nals = _split_nals(bits.read_bytes())
    drop = [i for i, (t, _) in enumerate(nals) if t == entropy.NAL_SAO][0]
    params = {entropy.NAL_VPS: 0, entropy.NAL_SPS: 1, entropy.NAL_PPS: 2}
    out = []
    for i, (t, p) in enumerate(nals):
        if i == drop:
            continue
        if t in params:
            p = entropy.write_params(32, 32, 8, 22, params[t], mode_mpm_flag=1)
        out.append(entropy.wrap_nal(t, p))
    mixed = tmp_path / "mixed.bin"
    mixed.write_bytes(b"".join(out))
    dec_j, dec_t = tmp_path / "j.yuv", tmp_path / "t.yuv"
    assert jax_seq.decode_sequence(str(mixed), str(dec_j)) == 2
    assert seq.decode_sequence(str(mixed), str(dec_t), device="cpu") == 2
    assert dec_t.read_bytes() == dec_j.read_bytes()


def test_sequence_decode_mixed_block_sizes_with_sao(tmp_path):
    """A chunk whose frames change block size decodes frame by frame,
    each with its own CTB-SAO maps, as JAX decodes it."""
    src = tmp_path / "seq.yuv"
    write_sequence(src, 32, 32, 2, seed=9)
    head, units = None, []
    for bs in (8, 16):
        bits = tmp_path / f"bs{bs}.bin"
        seq.encode_sequence(str(src), 32, 32, 2, port_config.EncoderConfig(
            block_size=bs, deblock=True, sao_ctb=True, sao_tile=16), str(bits),
            batch=2, closed_loop=True, device="cpu")
        nals = [(t, entropy.wrap_nal(t, p)) for t, p in
                _split_nals(bits.read_bytes())]
        params = (entropy.NAL_VPS, entropy.NAL_SPS, entropy.NAL_PPS)
        head = head or [n for t, n in nals if t in params]
        units += [n for t, n in nals if t not in params]
    mixed = tmp_path / "mixed.bin"
    mixed.write_bytes(b"".join(head + units))
    dec_j, dec_t = tmp_path / "j.yuv", tmp_path / "t.yuv"
    assert jax_seq.decode_sequence(str(mixed), str(dec_j)) == 4
    assert seq.decode_sequence(str(mixed), str(dec_t), device="cpu") == 4
    assert dec_t.read_bytes() == dec_j.read_bytes()
