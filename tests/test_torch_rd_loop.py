"""The port's RD stages on the closed loop, the batch encoders, the
sequence runner and the CLI vs the JAX package's.

The closed loop runs RDOQ inside the loop (its plain path, as JAX's XLA
scan does) and `decision="rd"` on JAX's own batches: frame by frame,
each diagonal on all nby slots of the skewed layout, the slots off the
plane included.  The geometries here have such slots (5 x 7 blocks,
batch 2).  Recon, levels, modes, bytes and decoded pixels must be
equal to JAX's (jitted, XLA path) on the CPU.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import nanohevc_tpu.models.sequence as jax_seq
import nanohevc_tpu.models.wavefront as jax_wf
import nanohevc_tpu.parallel.sharding as jax_sharding
from nanohevc_tpu.cli import main as jax_main
from nanohevc_tpu.config import EncoderConfig as JaxConfig
from nanohevc_tpu.frame import Frame as JaxFrame
from nanohevc_tpu.frame import Plane as JaxPlane
from nanohevc_tpu_torch.cli import main as torch_main
from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.frame import Frame, Plane
from nanohevc_tpu_torch.kernels import wavefront_rd as krd
from nanohevc_tpu_torch.models import sequence as seq
from nanohevc_tpu_torch.models import wavefront as torch_wf
from nanohevc_tpu_torch.parallel import sharding as torch_sharding


def textured(h, w, seed, bit_depth=8):
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * (peak + 1) // max(h, 1) + xx * (peak + 1) // (2 * w)
            + (peak // 6) * np.sin(xx / 5.0 + yy / 9.0))
    noise = rng.integers(-peak // 20, peak // 20 + 1, (h, w))
    return np.clip(base + noise, 0, peak).astype(np.int32)


def planes(b, h, w, seed, bit_depth=8):
    return np.stack([textured(h, w, seed + i, bit_depth) for i in range(b)])


# --- the skewed layout --------------------------------------------------------

@pytest.mark.parametrize("nby,nbx", [(5, 7), (7, 5), (1, 4), (4, 1)])
def test_skew_and_deskew_match_jax(nby, nbx):
    raster = np.random.default_rng(nby * 10 + nbx).integers(
        -99, 99, (2, nby * nbx, 3, 3)).astype(np.int32)
    want = np.asarray(jax_wf._skew_blocks(jnp.asarray(raster), nby, nbx))
    got = krd._skew_blocks(torch.from_numpy(raster), nby, nbx)
    assert np.array_equal(got.numpy(), want)       # invalid slots included
    back = krd._deskew_blocks(got, nby, nbx)
    assert np.array_equal(back.numpy(), raster)
    assert np.array_equal(
        np.asarray(jax_wf._deskew_blocks(jnp.asarray(want), nby, nbx)), raster)
    for j, t in zip(jax_wf._skew_tables(nby, nbx),
                    krd._skew_tables(nby, nbx)):
        assert np.array_equal(j, t)


@pytest.mark.parametrize("d", [0, 3, 10])
def test_skewed_buffer_reads_and_writes_match_jax(d):
    nby, nbx, n = 5, 7, 4
    rng = np.random.default_rng(d)
    j_bot, j_r = jax_wf._skew_buffers(nby, nbx, n)
    s_bot = rng.integers(0, 256, j_bot.shape).astype(np.int32)
    r_sp = rng.integers(0, 256, j_r.shape).astype(np.int32)
    bx, ok = (t[d] for t in jax_wf._skew_tables(nby, nbx))
    want = np.asarray(jax_wf._read_refs_skewed(
        jnp.asarray(s_bot), jnp.asarray(r_sp), d, n, nby, 128, jnp.asarray(bx)))
    got = krd._read_refs_skewed(torch.from_numpy(s_bot),
                                torch.from_numpy(r_sp), d, n, nby, 128,
                                torch.from_numpy(bx))
    assert np.array_equal(got.numpy(), want)
    rec = rng.integers(0, 256, (nby, n, n)).astype(np.int32)
    wb, wr = jax_wf._write_bufs_skewed(
        jnp.asarray(s_bot), jnp.asarray(r_sp), jnp.asarray(rec), d,
        jnp.asarray(ok), jnp.asarray(bx), n, nby, nbx, True, True)
    tb, tr = torch.from_numpy(s_bot.copy()), torch.from_numpy(r_sp.copy())
    krd._write_bufs_skewed(tb, tr, torch.from_numpy(rec), d,
                           torch.from_numpy(ok), torch.from_numpy(bx),
                           n, nby, nbx)
    assert np.array_equal(tb.numpy(), np.asarray(wb))
    assert np.array_equal(tr.numpy(), np.asarray(wr))


# --- the closed loop ----------------------------------------------------------

CLOSED = [
    ("rdoq", 8, (40, 56), 22, dict(rdoq=True)),
    ("rdoq_search", 8, (40, 56), 30,
     dict(rdoq=True, mode_set="all", decision="satd")),
    ("rd", 8, (40, 56), 22, dict(decision="rd")),
    ("rd_all", 8, (40, 56), 27, dict(decision="rd", mode_set="all")),
    ("rd_rdoq_dst_mode_scan", 4, (20, 28), 12,
     dict(decision="rd", rdoq=True, scan="mode", use_dst=True)),
    ("rdoq_10bit_rescale", 16, (80, 112), 37,
     dict(rdoq=True, dequant_rescale=True, bit_depth=10)),
    ("rd_all_ragged_smoothing", 8, (37, 53), 22,
     dict(decision="rd", mode_set="all", intra_smoothing=True)),
    ("rd_rdoq_lambda_scale", 8, (40, 56), 22,
     dict(decision="rd", rdoq=True, rd_lambda_scale=3.0)),
]


def jax_closed(p, qp, n, kw):
    return {k: np.asarray(v) for k, v in jax.jit(
        lambda x, q: jax_wf.encode_planes_closed_loop(x, q, n=n, **kw))(
            jnp.asarray(p), jnp.int32(qp)).items()}


@pytest.mark.parametrize("name,n,shape,qp,kw", CLOSED, ids=[c[0] for c in CLOSED])
def test_closed_loop_rd_matches_jax(name, n, shape, qp, kw):
    """Batch 2 on a geometry whose skewed layout has invalid slots; the
    port's stream decodes to its recon pixel for pixel."""
    p = planes(2, *shape, 3 * n + qp, kw.get("bit_depth", 8))
    want = jax_closed(p, qp, n, kw)
    got = torch_wf.encode_planes_closed_loop(torch.from_numpy(p), qp, n=n,
                                             **kw)
    for k in ("recon", "levels", "modes"):
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), want[k]), k
    dec = torch_wf.decode_planes(
        got["levels"], got["modes"], [qp, qp], n=n, height=shape[0],
        width=shape[1], use_dst=kw.get("use_dst", False),
        bit_depth=kw.get("bit_depth", 8), scan=kw.get("scan", "diag"),
        dequant_rescale=kw.get("dequant_rescale", False),
        intra_smoothing=kw.get("intra_smoothing", False))
    assert torch.equal(dec, got["recon"])


def test_closed_loop_rd_frames_are_decided_apart():
    """Each frame of a batch is priced on its own slot batches: frame 1
    of a batch equals frame 1 encoded alone."""
    p = planes(2, 40, 56, 11)
    both = torch_wf.encode_planes_closed_loop(torch.from_numpy(p), 22, n=8,
                                              decision="rd")
    alone = torch_wf.encode_planes_closed_loop(torch.from_numpy(p[1:]), 22,
                                               n=8, decision="rd")
    for k in both:
        assert torch.equal(both[k][1], alone[k][0]), k


def test_closed_loop_rdoq_refuses_the_kernel():
    p = torch.from_numpy(planes(1, 16, 16, 1))
    with pytest.raises(ValueError, match="rdoq"):
        torch_wf.encode_planes_closed_loop(p, 22, n=8, rdoq=True,
                                           allow_fast=True)
    with pytest.raises(ValueError, match="rdoq"):
        jax_wf.encode_planes_closed_loop(jnp.asarray(p.numpy()), 22, n=8,
                                         rdoq=True, allow_fast=True)


def _frames(h, w, seed):
    planes_ = (textured(h, w, seed), textured(h // 2, w // 2, seed + 1),
               textured(h // 2, w // 2, seed + 2))
    return (JaxFrame(*(JaxPlane(p.astype(np.int16)) for p in planes_)),
            Frame(*(Plane(p.astype(np.int16)) for p in planes_)))


@pytest.mark.parametrize("cfg", [dict(rdoq=True), dict(decision="rd"),
                                 dict(decision="rd", rdoq=True, block_size=16,
                                      scan="mode")],
                         ids=["rdoq", "rd", "rd_rdoq_16"])
def test_encode_frame_closed_loop_rd_matches_jax(cfg):
    jf, tf = _frames(24, 40, 5)
    jr, jbits = jax_wf.encode_frame_closed_loop(jf, JaxConfig(qp=24, **cfg))
    tr, tbits = torch_wf.encode_frame_closed_loop(tf, EncoderConfig(qp=24, **cfg),
                                                  device="cpu")
    assert tbits == jbits
    dec = torch_wf.decode_frame(tbits, device="cpu")
    for p in "yuv":
        assert np.array_equal(getattr(tr, p).data, getattr(jr, p).data)
        assert np.array_equal(getattr(dec, p).data, getattr(tr, p).data)


# --- batch encoders -----------------------------------------------------------

@pytest.mark.parametrize("cfg,is_luma", [
    (dict(rdo_cbf=True, rdoq=True), True),
    (dict(decision="rd", mode_set="all", rdo_cbf=True), False),
])
def test_batch_encoder_rd_matches_jax(cfg, is_luma):
    """Open loop: each plane of the batch is priced on its own, as JAX's
    vmap over frames does."""
    p = planes(2, 32, 48, 21)
    want = jax_sharding.make_batch_encoder(JaxConfig(qp=22, **cfg),
                                           is_luma=is_luma)(
        jnp.asarray(p), jnp.int32(22))
    got = torch_sharding.make_batch_encoder(EncoderConfig(qp=22, **cfg),
                                            is_luma=is_luma)(
        torch.from_numpy(p), 22)
    for k in ("recon", "levels", "modes", "nnz"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    np.testing.assert_allclose(got["psnr"].numpy(), np.asarray(want["psnr"]),
                               rtol=1e-6)


@pytest.mark.parametrize("cfg", [dict(rdoq=True), dict(decision="rd")],
                         ids=["rdoq", "rd"])
def test_closed_loop_encoder_rd_matches_jax(cfg):
    p = planes(2, 24, 40, 31)
    want = jax_sharding.make_closed_loop_encoder(JaxConfig(qp=26, **cfg))(
        jnp.asarray(p), jnp.int32(26))
    got = torch_sharding.make_closed_loop_encoder(EncoderConfig(qp=26, **cfg))(
        torch.from_numpy(p), 26)
    for k in ("recon", "levels", "modes"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


# --- the sequence runner ------------------------------------------------------

def write_sequence(path, width, height, frames, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, frames * width * height * 3 // 2, dtype=np.uint8)
    path.write_bytes((data // 3 + 80).astype(np.uint8).tobytes())
    return path


def run_both(tmp_path, src, size, frames, cfg, **kw):
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


@pytest.mark.parametrize("cfg,closed,kw", [
    (dict(rdo_cbf=True, rdoq=True), False, {}),
    (dict(rdoq=True), True, {}),
    (dict(decision="rd"), True, {}),
    (dict(rdo_cbf=True, rdoq=True, qp=20), False, dict(target_bpp=1.5)),
    (dict(rdoq=True, qp=20), True, dict(target_bpp=1.5)),
], ids=["open_rdo_rdoq", "closed_rdoq", "closed_rd", "open_rc", "closed_rc"])
def test_sequence_rd_matches_jax(tmp_path, cfg, closed, kw):
    src = write_sequence(tmp_path / "s.yuv", 32, 32, 5, seed=len(cfg))
    (jr, jb, js), (tr, tb, ts) = run_both(tmp_path, src, (32, 32), 5, cfg,
                                          batch=2, closed_loop=closed, **kw)
    assert tb == jb and ts == js
    assert tr.bytes_written == jr.bytes_written
    assert tr.mean_psnr_y == pytest.approx(jr.mean_psnr_y, rel=1e-6)
    assert tr.stats.get("rate_control") == jr.stats.get("rate_control")
    if closed:
        dec = tmp_path / "dec.yuv"
        assert seq.decode_sequence(str(tmp_path / "port.bin"), str(dec),
                                   device="cpu") == 5
        jdec = tmp_path / "jdec.yuv"
        jax_seq.decode_sequence(str(tmp_path / "jax.bin"), str(jdec))
        assert dec.read_bytes() == jdec.read_bytes()


def test_sequence_rdoq_resumes(tmp_path):
    """3 frames, then resumed to 6: byte-identical to a straight run."""
    src = write_sequence(tmp_path / "s.yuv", 32, 32, 6, seed=3)
    cfg = EncoderConfig(rdoq=True, rdo_cbf=True)
    straight, part = tmp_path / "a.bin", tmp_path / "b.bin"
    seq.encode_sequence(str(src), 32, 32, 6, cfg, str(straight), batch=2,
                        device="cpu")
    seq.encode_sequence(str(src), 32, 32, 3, cfg, str(part), batch=2,
                        device="cpu")
    res = seq.encode_sequence(str(src), 32, 32, 6, cfg, str(part), batch=2,
                              device="cpu")
    assert (res.resumed_from, res.frames) == (3, 6)
    assert part.read_bytes() == straight.read_bytes()


# --- the CLI ------------------------------------------------------------------

def _run_both_cli(capsys, args, outputs):
    results = []
    for run, flag in ((jax_main, ["--platform", "cpu"]),
                      (torch_main, ["--device", "cpu"])):
        for path in outputs:
            if os.path.exists(path):
                os.remove(path)
        run(flag + args)
        files = {}
        for path in outputs:
            with open(path, "rb") as f:
                files[path] = f.read()
        results.append((capsys.readouterr().out, files))
    return results


@pytest.fixture
def yuv_frame(tmp_path):
    _, frame = _frames(32, 48, 77)
    src = tmp_path / "in.yuv"
    src.write_bytes(frame.to_yuv420p())
    return tmp_path, str(src)


@pytest.mark.parametrize("extra", [
    ["--pipeline", "full", "--rdo", "--rdoq"],
    ["--pipeline", "full", "--decision", "rd"],
    ["--pipeline", "full", "--mode-search", "--decision", "rd", "--rdo"],
    ["--pipeline", "full", "--rdo", "--rdoq", "--target-bytes", "700"],
    ["--pipeline", "closed-loop", "--rdoq"],
    ["--pipeline", "closed-loop", "--decision", "rd", "--rdo"],
], ids=["full_rdo_rdoq", "full_rd", "full_search_rd", "full_target_bytes",
        "closed_rdoq", "closed_rd"])
def test_encode_rd_flags_identical(capsys, yuv_frame, extra):
    tmp, src = yuv_frame
    out, bits = str(tmp / "out.yuv"), str(tmp / "out.bin")
    (jout, jf), (tout, tf) = _run_both_cli(
        capsys, ["encode", src, "--width", "48", "--height", "32", "-o", out,
                 "--bitstream", bits] + extra, outputs=[out, bits])
    assert tout == jout
    assert tf == jf


@pytest.mark.parametrize("extra", [["--rdo", "--rdoq"],
                                   ["--closed-loop", "--rdoq"],
                                   ["--closed-loop", "--decision", "rd"]],
                         ids=["open", "closed_rdoq", "closed_rd"])
def test_encode_seq_rd_flags_identical(capsys, tmp_path, extra):
    src = write_sequence(tmp_path / "s.yuv", 32, 32, 3, seed=8)
    bits = str(tmp_path / "s.bin")
    (jout, jf), (tout, tf) = _run_both_cli(
        capsys, ["encode-seq", str(src), "--width", "32", "--height", "32",
                 "--frames", "3", "--batch", "2", "--no-resume",
                 "--bitstream", bits] + extra, outputs=[bits, bits + ".progress"])
    assert tf == jf
    strip = [ln for ln in tout.splitlines() if "Throughput" not in ln
             and not ln.startswith("    ")]
    assert strip == [ln for ln in jout.splitlines() if "Throughput" not in ln
                     and not ln.startswith("    ")]


def test_rdoq_needs_a_coded_pipeline(capsys, yuv_frame):
    _, src = yuv_frame
    for run, flag in ((jax_main, ["--platform", "cpu"]),
                      (torch_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            run(flag + ["encode", src, "--width", "48", "--height", "32",
                        "--rdoq"])
        assert exc.value.code == 1
        assert "--rdoq adjusts quantized levels" in capsys.readouterr().err
