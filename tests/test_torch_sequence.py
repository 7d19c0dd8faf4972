"""The port's sequence runner and decoder vs the JAX package's.

The same seeded YUV files go through `nanohevc_tpu.models.sequence`
and `nanohevc_tpu_torch.models.sequence` (on the CPU).  Bitstream
bytes, the resume sidecar, the frame counts, the per-frame slice QPs
and the decoded pixels must be equal; mean_psnr_y agrees within rtol
1e-6 (a float32 mean, summed in another order by each framework).

Where the JAX runner would route a plane to a Pallas kernel that runs
slowly through the CPU interpreter (the 35-mode search, open and closed
loop), the JAX side is pinned to its XLA formulation instead, which its
own tests hold bit-exact against those kernels.
"""

import json
import struct

import numpy as np
import pytest

import torch

import nanohevc_tpu.models.all_intra as jax_ai
import nanohevc_tpu.models.sequence as jax_seq
import nanohevc_tpu.models.wavefront as jax_wf
import nanohevc_tpu.parallel.sharding as jax_sharding
from nanohevc_tpu.config import EncoderConfig as JaxConfig
from nanohevc_tpu.runtime.entropy import CorruptBitstreamError as JaxCorrupt
from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.models import sequence as seq
from nanohevc_tpu_torch.runtime import entropy
from nanohevc_tpu_torch.runtime.bitstream import _split_nals
from nanohevc_tpu_torch.runtime.entropy import CorruptBitstreamError

SEARCH = dict(mode_set="all", decision="satd")


def write_sequence(path, width, height, frames, seed=0):
    """Seeded frames with smooth structure (sparse levels), as the JAX
    package's tests/test_sequence.py writes them."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, frames * width * height * 3 // 2, dtype=np.uint8)
    path.write_bytes((data // 4 + 96).astype(np.uint8).tobytes())


@pytest.fixture
def jax_xla_search(monkeypatch):
    """Pin the JAX runner's 35-mode search to its XLA formulation."""
    monkeypatch.setattr(jax_ai, "supports_mode_search_fast_path",
                        lambda *a, **k: False)
    real = jax_wf.encode_planes_closed_loop

    def xla_scan(*a, **kw):
        kw["allow_fast"] = False if kw.get("mode_set") == "all" else None
        return real(*a, **kw)

    monkeypatch.setattr(jax_wf, "encode_planes_closed_loop", xla_scan)
    for cache in (jax_sharding._batch_encoder_unsharded, jax_seq._closed_loop_jit):
        cache.cache_clear()
    yield
    for cache in (jax_sharding._batch_encoder_unsharded, jax_seq._closed_loop_jit):
        cache.cache_clear()


def run_both(tmp_path, src, size, frames, cfg=None, **kw):
    """encode_sequence of both packages into their own bitstreams;
    returns (jax result, port result) as (SequenceResult, bytes,
    sidecar text)."""
    cfg = cfg or {}
    out = []
    for tag, mod, config, extra in (
            ("jax", jax_seq, JaxConfig(**cfg), {}),
            ("port", seq, EncoderConfig(**cfg), {"device": "cpu"})):
        bits = tmp_path / f"{tag}.bin"
        res = mod.encode_sequence(str(src), *size, frames, config, str(bits),
                                  **kw, **extra)
        out.append((res, bits.read_bytes(),
                    (tmp_path / f"{tag}.bin.progress").read_text()))
    return out


def assert_same(jax_run, port_run):
    (jr, jb, js), (tr, tb, ts) = jax_run, port_run
    assert tb == jb
    assert ts == js
    assert (tr.frames, tr.resumed_from, tr.bytes_written) == (
        jr.frames, jr.resumed_from, jr.bytes_written)
    assert tr.mean_psnr_y == pytest.approx(jr.mean_psnr_y, rel=1e-6)
    assert tr.stats.get("rate_control") == jr.stats.get("rate_control")
    assert list(tr.stats)[:4] == ["load", "dispatch", "fetch", "entropy"]


def slice_qps(path):
    return [fr["Y"].get("qp") for fr in seq.decode_sequence_levels(str(path))]


@pytest.fixture
def seq64(tmp_path):
    src = tmp_path / "seq64.yuv"
    write_sequence(src, 64, 32, 8)
    return src


@pytest.fixture
def seq32(tmp_path):
    src = tmp_path / "seq32.yuv"
    write_sequence(src, 32, 32, 4, seed=9)
    return src


def test_open_loop_ragged_tail(tmp_path, seq64):
    """6 frames at batch 4: the last batch is padded with copies of
    frame 5, and V of frame i is chroma entry batch + i."""
    j, t = run_both(tmp_path, seq64, (64, 32), 6, batch=4)
    assert_same(j, t)
    frames = seq.decode_sequence_levels(str(tmp_path / "port.bin"))
    assert len(frames) == 6
    assert frames[0]["Y"]["levels"].shape == (32, 64)
    assert frames[0]["U"]["levels"].shape == (32, 16)
    assert not np.array_equal(frames[5]["U"]["levels"], frames[5]["V"]["levels"])


def test_open_loop_mode_search(tmp_path, seq64, jax_xla_search):
    assert_same(*run_both(tmp_path, seq64, (64, 32), 5, SEARCH, batch=4))


def test_open_loop_intra_smoothing(tmp_path, seq64):
    """Luma smoothing takes the plain route, chroma the slab kernel's."""
    assert_same(*run_both(tmp_path, seq64, (64, 32), 5,
                          dict(intra_smoothing=True, block_size=16), batch=4))


@pytest.mark.parametrize("cfg", [{}, SEARCH], ids=["dc_planar", "search"])
def test_closed_loop_dequant_rescale(tmp_path, seq32, jax_xla_search, cfg):
    j, t = run_both(tmp_path, seq32, (32, 32), 3,
                    dict(cfg, dequant_rescale=True, qp=24), batch=2,
                    closed_loop=True)
    assert_same(j, t)
    dec_j, dec_t = tmp_path / "dec_j.yuv", tmp_path / "dec_t.yuv"
    assert jax_seq.decode_sequence(str(tmp_path / "jax.bin"), str(dec_j)) == 3
    assert seq.decode_sequence(str(tmp_path / "port.bin"), str(dec_t),
                               device="cpu") == 3
    assert dec_t.read_bytes() == dec_j.read_bytes()


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_rate_control_same_qp_schedule(tmp_path, seq64, closed):
    j, t = run_both(tmp_path, seq64, (64, 32), 7, dict(qp=20), batch=2,
                    target_bpp=1.2, closed_loop=closed)
    assert_same(j, t)
    qps = slice_qps(tmp_path / "port.bin")
    assert qps == slice_qps(tmp_path / "jax.bin")
    assert len(set(qps)) > 1                # the controller moved the QP
    assert json.loads(t[2])["qp"] == t[0].stats["rate_control"]["qp_final"]


def test_resume_from_a_jax_sidecar(tmp_path, seq32):
    """JAX encodes 4 of 8 frames; the port resumes its bitstream and
    sidecar to 8, byte-identical to a straight run, and so does its
    own resume."""
    write_sequence(seq32, 32, 32, 8, seed=4)
    cfg = dict(qp=30)
    straight = tmp_path / "straight.bin"
    jax_seq.encode_sequence(str(seq32), 32, 32, 8, JaxConfig(**cfg),
                            str(straight), batch=2)
    for tag, first, config, kw in (
            ("jax", jax_seq, JaxConfig(**cfg), {}),
            ("port", seq, EncoderConfig(**cfg), {"device": "cpu"})):
        bits = tmp_path / f"resumed_{tag}.bin"
        r1 = first.encode_sequence(str(seq32), 32, 32, 4, config, str(bits),
                                   batch=2, **kw)
        assert r1.frames == 4
        r2 = seq.encode_sequence(str(seq32), 32, 32, 8, EncoderConfig(**cfg),
                                 str(bits), batch=2, device="cpu")
        assert (r2.resumed_from, r2.frames) == (4, 8)
        assert bits.read_bytes() == straight.read_bytes()
        assert ((tmp_path / (bits.name + ".progress")).read_text()
                == (tmp_path / "straight.bin.progress").read_text())


def test_resume_restores_the_rate_control_qp(tmp_path, seq64):
    """A rate-controlled run resumed by the port continues from the
    sidecar's QP exactly as the JAX runner does."""
    outs = []
    for mod, cfg, kw in ((jax_seq, JaxConfig(qp=20), {}),
                         (seq, EncoderConfig(qp=20), {"device": "cpu"})):
        bits = tmp_path / f"{mod.__name__.split('.')[0]}.bin"
        jax_seq.encode_sequence(str(seq64), 64, 32, 4, JaxConfig(qp=20),
                                str(bits), batch=2, target_bpp=1.0)
        res = mod.encode_sequence(str(seq64), 64, 32, 8, cfg, str(bits),
                                  batch=2, target_bpp=1.0, **kw)
        assert res.resumed_from == 4
        outs.append((bits.read_bytes(), res.stats["rate_control"]))
    assert outs[1] == outs[0]


def test_corrupt_sidecar_restarts(tmp_path, seq32):
    bits = tmp_path / "seq.bin"
    cfg = EncoderConfig(qp=22)
    seq.encode_sequence(str(seq32), 32, 32, 3, cfg, str(bits), batch=2,
                        device="cpu")
    want = bits.read_bytes()
    (tmp_path / "seq.bin.progress").write_text("{broken json")
    res = seq.encode_sequence(str(seq32), 32, 32, 3, cfg, str(bits), batch=2,
                              device="cpu")
    assert res.resumed_from == 0 and res.frames == 3
    assert bits.read_bytes() == want
    assert len(seq.decode_sequence_levels(str(bits))) == 3


def test_short_input_stops_cleanly(tmp_path):
    src = tmp_path / "short.yuv"
    write_sequence(src, 32, 32, 2)
    j, t = run_both(tmp_path, src, (32, 32), 10)
    assert_same(j, t)
    assert t[0].frames == 2


def test_decode_sequence_levels_match_jax(tmp_path, seq64):
    run_both(tmp_path, seq64, (64, 32), 3, dict(scan="mode", block_size=4),
             batch=2)
    want = jax_seq.decode_sequence_levels(str(tmp_path / "jax.bin"))
    got = seq.decode_sequence_levels(str(tmp_path / "port.bin"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in ("Y", "U", "V"):
            for k, v in w[name].items():
                if isinstance(v, np.ndarray):
                    assert np.array_equal(g[name][k], v), (name, k)
                else:
                    assert g[name][k] == v, (name, k)


def _frames_of(path):
    """(header NAL bytes, [access unit bytes]) of a sequence stream."""
    head, units = [], []
    for t, payload in _split_nals(path.read_bytes()):
        nal = entropy.wrap_nal(t, payload)
        if t == seq.NAL_AUD:
            units.append(nal)
        elif t in (entropy.NAL_VPS, entropy.NAL_SPS, entropy.NAL_PPS):
            head.append(nal)
        else:
            units[-1] += nal
    return head, units


def test_decode_mixed_block_sizes(tmp_path, seq32):
    """Frames whose slices change block size inside a chunk decode one
    by one, as in the JAX decoder."""
    parts = []
    for bs in (8, 16):
        bits = tmp_path / f"bs{bs}.bin"
        seq.encode_sequence(str(seq32), 32, 32, 2, EncoderConfig(block_size=bs),
                            str(bits), batch=2, closed_loop=True, device="cpu")
        parts.append(_frames_of(bits))
    mixed = tmp_path / "mixed.bin"
    mixed.write_bytes(b"".join(parts[0][0] + parts[0][1] + parts[1][1]))
    dec_j, dec_t = tmp_path / "dj.yuv", tmp_path / "dt.yuv"
    assert jax_seq.decode_sequence(str(mixed), str(dec_j)) == 4
    assert seq.decode_sequence(str(mixed), str(dec_t), device="cpu") == 4
    assert dec_t.read_bytes() == dec_j.read_bytes()


def _with_params(tmp_path, src, **flags):
    """A closed-loop 2-frame stream whose parameter sets are rewritten
    with the given write_params flags."""
    bits = tmp_path / "base.bin"
    seq.encode_sequence(str(src), 32, 32, 2, EncoderConfig(), str(bits),
                        batch=2, closed_loop=True, device="cpu")
    _, units = _frames_of(bits)
    head = b"".join(
        entropy.wrap_nal(t, entropy.write_params(
            32, 32, 8, 22, which, scan_idx=0, rescale_flag=0,
            smoothing_flag=0, entropy_idx=0, mode_mpm_flag=1, **flags))
        for which, t in enumerate((entropy.NAL_VPS, entropy.NAL_SPS,
                                   entropy.NAL_PPS)))
    out = tmp_path / "flagged.bin"
    out.write_bytes(head + b"".join(units))
    return out


def test_decode_corrupt_streams_raise(tmp_path, seq32):
    garbage = tmp_path / "garbage.bin"
    garbage.write_bytes(b"\x00\x00\x01garbage")
    no_sao = _with_params(tmp_path, seq32, sao_flag=1)
    for path, match in ((garbage, "no usable SPS/PPS"),
                        (no_sao, "no SAO NAL")):
        with pytest.raises(JaxCorrupt, match=match):
            jax_seq.decode_sequence(str(path), str(tmp_path / "d.yuv"))
        with pytest.raises(CorruptBitstreamError, match=match):
            seq.decode_sequence(str(path), str(tmp_path / "d.yuv"), device="cpu")


def test_decode_refuses_deblocked_streams(tmp_path, seq32):
    """A stream whose parameter sets switch deblocking on decodes with
    the filter, as JAX's decoder decodes it (once refused here)."""
    flagged = _with_params(tmp_path, seq32, deblock_flag=1)
    dec_j, dec_t = tmp_path / "dj.yuv", tmp_path / "dt.yuv"
    assert jax_seq.decode_sequence(str(flagged), str(dec_j)) == 2
    assert seq.decode_sequence(str(flagged), str(dec_t), device="cpu") == 2
    assert dec_t.read_bytes() == dec_j.read_bytes()
    plain = tmp_path / "plain.yuv"
    seq.decode_sequence(str(tmp_path / "base.bin"), str(plain), device="cpu")
    assert dec_t.read_bytes() != plain.read_bytes()


@pytest.mark.parametrize("cfg,closed", [
    (dict(deblock=True), False),
    (dict(sao=True), False),
    (dict(sao_ctb=True), False),
    (dict(deblock=True), True),
    (dict(sao=True), True),
    (dict(sao_ctb=True), True),
])
def test_refusals(tmp_path, seq32, cfg, closed):
    """The filters need the closed loop: the open loop raises ValueError
    before writing anything, as in JAX; the closed loop encodes JAX's
    bytes and sidecar."""
    if not closed:
        bits = tmp_path / "never.bin"
        for mod, config, extra in (
                (jax_seq, JaxConfig(**cfg), {}),
                (seq, EncoderConfig(**cfg), {"device": "cpu"})):
            with pytest.raises(ValueError, match="closed_loop=True"):
                mod.encode_sequence(str(seq32), 32, 32, 2, config, str(bits),
                                    closed_loop=False, **extra)
            assert not bits.exists()
        return
    assert_same(*run_both(tmp_path, seq32, (32, 32), 2, cfg, batch=2,
                          closed_loop=True))


def test_sequence_under_frame_mesh_equals_jax(tmp_path, seq32):
    """Both runners under an 8-device frame mesh (2 frames padded to a
    batch of 8): the port gives JAX's bytes and sidecar."""
    from nanohevc_tpu.parallel import make_mesh as jax_make_mesh
    from nanohevc_tpu_torch.parallel import make_mesh

    runs = []
    for tag, mod, config, mesh, extra in (
            ("jax", jax_seq, JaxConfig(), jax_make_mesh(), {}),
            ("port", seq, EncoderConfig(), make_mesh(["cpu"] * 8),
             {"device": "cpu"})):
        bits = tmp_path / f"{tag}.bin"
        res = mod.encode_sequence(str(seq32), 32, 32, 2, config, str(bits),
                                  mesh=mesh, **extra)
        runs.append((res, bits.read_bytes(),
                     (tmp_path / f"{tag}.bin.progress").read_text()))
    assert_same(*runs)


def test_cuda_without_card_raises(tmp_path, seq32, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bits = tmp_path / "never.bin"
    with pytest.raises(RuntimeError, match="is_available"):
        seq.encode_sequence(str(seq32), 32, 32, 2, EncoderConfig(), str(bits))
    with pytest.raises(RuntimeError, match="is_available"):
        seq.decode_sequence(str(bits), str(tmp_path / "d.yuv"))
    assert not bits.exists()


def test_aud_carries_the_frame_index(tmp_path, seq32):
    bits = tmp_path / "seq.bin"
    seq.encode_sequence(str(seq32), 32, 32, 3, EncoderConfig(), str(bits),
                        batch=2, device="cpu")
    auds = [struct.unpack("<I", p)[0] for t, p in _split_nals(bits.read_bytes())
            if t == seq.NAL_AUD]
    assert auds == [0, 1, 2]
