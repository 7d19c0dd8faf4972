"""`python -m nanohevc_tpu_torch` vs `python -m nanohevc_tpu`.

For the same arguments (the port with --device cpu, the JAX CLI with
--platform cpu) stdout and the files written must be identical, for
`demo`, `encode` (predict, full and closed-loop pipelines) and
`decode`.  `encode-seq`, `decode` of a sequence and `encode --target-bytes` too.
The in-loop filter and standard-export flags give the JAX CLI's rc,
stdout, stderr and files, refusals and errors included; a missing card
fails instead of running on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from nanohevc_tpu.cli import main as jax_main
from nanohevc_tpu_torch.cli import main as torch_main
from nanohevc_tpu_torch.models.all_intra import create_test_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(run, argv):
    """rc of a CLI call: 0, its SystemExit code, or the type and text
    of the exception it raised."""
    try:
        run(argv)
    except SystemExit as e:
        return e.code
    except Exception as e:                 # both CLIs let config errors out
        return (type(e).__name__, str(e))
    return 0


def _run_both_rc(capsys, args, outputs=(), timing_free=False):
    """Run both CLIs; return (rc, stdout, stderr, files) of each (files
    that were not written read as None)."""
    results = []
    for run, flag in ((jax_main, ["--platform", "cpu"]),
                      (torch_main, ["--device", "cpu"])):
        for path in outputs:
            if os.path.exists(path):
                os.remove(path)
        rc = _outcome(run, flag + args)
        files = {}
        for path in outputs:
            files[path] = (open(path, "rb").read() if os.path.exists(path)
                           else None)
        out, err = capsys.readouterr()
        results.append((rc, _timing_free(out) if timing_free else out, err,
                        files))
    return results


def _run_both(capsys, args, outputs=()):
    """Run both CLIs with the same argv; return (stdout, files) of each."""
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


@pytest.mark.parametrize("w,h,bs", [(64, 64, 8), (48, 32, 4), (64, 96, 16)])
def test_demo_output_identical(capsys, w, h, bs):
    (jout, _), (tout, _) = _run_both(
        capsys, ["demo", "--width", str(w), "--height", str(h),
                 "--block-size", str(bs)])
    assert tout == jout
    if (w, h, bs) == (64, 64, 8):
        assert "DC wins:      32 (50.0%)" in tout
        assert "Planar wins:  32 (50.0%)" in tout
        assert "19.09 dB" in tout


@pytest.fixture
def yuv_input(tmp_path):
    frame = create_test_frame(48, 64)
    src = tmp_path / "in.yuv"
    src.write_bytes(frame.to_yuv420p())
    return tmp_path, str(src)


@pytest.mark.parametrize("bs", [4, 8])
def test_encode_predict_identical(capsys, yuv_input, bs):
    tmp, src = yuv_input
    out = str(tmp / "out.yuv")
    (jout, jf), (tout, tf) = _run_both(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "--block-size", str(bs), "-o", out], outputs=[out])
    assert tout == jout
    assert tf == jf
    assert "Y-PSNR" in tout


@pytest.mark.parametrize("extra", [
    [],
    ["--block-size", "16", "--qp", "37"],
    ["--block-size", "4", "--scan", "mode", "--dequant-rescale"],
    ["--decision", "sad", "--entropy", "cabac"],
])
def test_encode_full_bitstream_identical(capsys, yuv_input, extra):
    tmp, src = yuv_input
    out, bits = str(tmp / "out.yuv"), str(tmp / "out.bin")
    (jout, jf), (tout, tf) = _run_both(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "--pipeline", "full", "-o", out, "--bitstream", bits] + extra,
        outputs=[out, bits])
    assert tout == jout
    assert tf == jf
    assert "Bitstream:" in tout


@pytest.mark.parametrize("extra", [
    ["--mode-search", "--decision", "sad"],
    ["--mode-search", "--decision", "energy", "--intra-smoothing",
     "--block-size", "16"],
    ["--intra-smoothing"],
    ["--intra-smoothing", "--block-size", "32", "--qp", "30"],
    ["--mode-search", "--decision", "sad", "--block-size", "4", "--scan",
     "mode", "--entropy", "cabac"],
])
def test_encode_mode_search_flags_identical(capsys, yuv_input, extra):
    """Configurations whose JAX side stays on the XLA path."""
    tmp, src = yuv_input
    out, bits = str(tmp / "out.yuv"), str(tmp / "out.bin")
    (jout, jf), (tout, tf) = _run_both(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "--pipeline", "full", "-o", out, "--bitstream", bits] + extra,
        outputs=[out, bits])
    assert tout == jout
    assert tf == jf


@pytest.mark.parametrize("bs,qp,rescale", [
    (8, 22, False), (4, 22, False), (16, 22, True), (32, 37, False),
])
def test_encode_mode_search_satd_bytes(capsys, yuv_input, bs, qp, rescale):
    """--mode-search (SATD) bytes == the JAX runtime's bitstream of the
    JAX XLA outputs; the recon file == the JAX XLA recon."""
    from nanohevc_tpu.config import EncoderConfig
    from nanohevc_tpu.frame import Frame
    from nanohevc_tpu.runtime import assemble_bitstream
    from test_torch_encoder import _jax_frame_xla

    tmp, src = yuv_input
    out, bits = str(tmp / "out.yuv"), str(tmp / "out.bin")
    torch_main(["--device", "cpu", "encode", src, "--width", "64", "--height",
                "48", "--pipeline", "full", "--mode-search", "-o", out,
                "--bitstream", bits, "--block-size", str(bs), "--qp", str(qp)]
               + (["--dequant-rescale"] if rescale else []))
    assert "Bitstream:" in capsys.readouterr().out
    cfg = EncoderConfig(block_size=bs, qp=qp, mode_set="all", decision="satd",
                        dequant_rescale=rescale)
    with open(src, "rb") as f:
        frame = Frame.from_yuv420p(f.read(), 48, 64)
    recon, info = _jax_frame_xla(frame, cfg)
    want = assemble_bitstream(
        64, 48, cfg.qp,
        {k: (p["levels"], p["block_size"]) for k, p in info["planes"].items()},
        {k: p["modes"] for k, p in info["planes"].items()},
        bit_depth=cfg.bit_depth, scan=cfg.scan,
        dequant_rescale=cfg.dequant_rescale, intra_smoothing=False,
        entropy_coder=cfg.entropy_coder,
    )
    with open(bits, "rb") as f:
        assert f.read() == want
    with open(out, "rb") as f:
        assert f.read() == recon.to_yuv420p()


@pytest.mark.slow
@pytest.mark.parametrize("bs", [4, 8])
def test_encode_mode_search_identical_to_jax_cli(capsys, yuv_input, bs):
    """Against the JAX CLI itself, whose SATD search runs the Pallas
    kernels (interpreted on the CPU)."""
    tmp, src = yuv_input
    out, bits = str(tmp / "out.yuv"), str(tmp / "out.bin")
    (jout, jf), (tout, tf) = _run_both(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "--pipeline", "full", "--mode-search", "--block-size",
                 str(bs), "-o", out, "--bitstream", bits], outputs=[out, bits])
    assert tout == jout
    assert tf == jf


@pytest.mark.parametrize("flag", ["--mode-search", "--intra-smoothing"])
def test_predict_pipeline_ignores_search_flags(capsys, yuv_input, flag):
    """The JAX CLI ignores both flags under --pipeline predict."""
    tmp, src = yuv_input
    out = str(tmp / "out.yuv")
    (jout, jf), (tout, tf) = _run_both(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "-o", out, flag], outputs=[out])
    assert tout == jout
    assert tf == jf


@pytest.mark.parametrize("argv", [
    ["--rdo", "--deblock"], ["--rdoq", "--sao"],
    ["--deblock"], ["--sao"], ["--sao-ctb"], ["--sao-tile", "32"],
    ["--hevc-export", "x.hevc"], ["--hevc-mono"], ["--chroma-mode", "dc"],
    ["--pipeline", "closed-loop", "--rdoq", "--sao-ctb"],
    ["--pipeline", "closed-loop", "--deblock"],
    ["--decision", "rd", "--hevc-mono"],
])
def test_unported_encode_flags_exit_2(capsys, yuv_input, argv):
    """The flags the port once refused with rc 2, after `--pipeline
    full`: rc, stdout, stderr and files equal the JAX CLI's, whether it
    refuses (filters and export off the closed loop: rc 1), ignores the
    flag or encodes."""
    tmp, src = yuv_input
    out, bits, hevc = (str(tmp / f) for f in ("out.yuv", "out.bin", "x.hevc"))
    argv = [hevc if a == "x.hevc" else a for a in argv]
    jax_run, port_run = _run_both_rc(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "--pipeline", "full", "-o", out, "--bitstream", bits] + argv,
        outputs=[out, bits, hevc])
    assert port_run == jax_run
    assert "not yet ported" not in port_run[2]


@pytest.mark.parametrize("argv", [
    ["--platform", "cpu", "demo"],
])
def test_unported_commands_exit_2(capsys, tmp_path, argv):
    """--platform picks a JAX backend: the port refuses it with rc 2 and
    points at --device."""
    with pytest.raises(SystemExit) as exc:
        torch_main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--platform" in err and "--device" in err


@pytest.mark.parametrize("argv", [
    ["--rdo", "--deblock"], ["--decision", "rd", "--sao"],
])
def test_open_loop_sequence_filters_raise_as_jax(capsys, yuv_sequence, argv):
    """`encode-seq` with a filter and without --closed-loop raises the
    JAX runner's ValueError, and writes no bitstream."""
    tmp, src = yuv_sequence
    bits = str(tmp / "never.bin")
    jax_run, port_run = _run_both_rc(
        capsys, ["encode-seq", src, "--width", "64", "--height", "32",
                 "--frames", "2", "--bitstream", bits] + argv,
        outputs=[bits])
    assert port_run == jax_run
    assert port_run[0][0] == "ValueError" and port_run[3][bits] is None


@pytest.mark.parametrize("extra", [
    [],
    ["--qp", "20", "--block-size", "4", "--scan", "mode"],
    ["--block-size", "16", "--entropy", "cabac", "--dequant-rescale"],
    ["--intra-smoothing", "--entropy", "hevc-slice"],
    ["--mode-search", "--decision", "sad", "--qp", "30"],
    ["--decision", "satd", "--block-size", "32"],
])
def test_closed_loop_and_decode_identical(capsys, yuv_input, extra):
    """`encode --pipeline closed-loop` then `decode`: stdout, recon,
    bitstream and decoded YUV equal the JAX CLI's (whose DC/planar
    closed loop runs its K4 kernel in interpret mode here)."""
    tmp, src = yuv_input
    out, bits, dec = (str(tmp / f) for f in ("out.yuv", "out.bin", "dec.yuv"))
    results = []
    for run, flag in ((jax_main, ["--platform", "cpu"]),
                      (torch_main, ["--device", "cpu"])):
        for path in (out, bits, dec):
            if os.path.exists(path):
                os.remove(path)
        run(flag + ["encode", src, "--width", "64", "--height", "48",
                    "--pipeline", "closed-loop", "-o", out, "--bitstream",
                    bits] + extra)
        run(flag + ["decode", bits, "-o", dec])
        files = []
        for path in (out, bits, dec):
            with open(path, "rb") as f:
                files.append(f.read())
        results.append((capsys.readouterr().out, files))
    (jout, jf), (tout, tf) = results
    assert tout == jout
    assert tf == jf
    assert tf[0] == tf[2]                 # decode == encoder recon
    assert "decodable" in tout and "Decoded:" in tout


def test_closed_loop_mode_search_round_trip(capsys, yuv_input):
    """--mode-search (SATD) in the closed loop: the port's bytes equal
    the port's library encode, and decode gives back the recon."""
    from nanohevc_tpu_torch.config import EncoderConfig
    from nanohevc_tpu_torch.frame import Frame
    from nanohevc_tpu_torch.models.wavefront import encode_frame_closed_loop

    tmp, src = yuv_input
    out, bits, dec = (str(tmp / f) for f in ("out.yuv", "out.bin", "dec.yuv"))
    torch_main(["--device", "cpu", "encode", src, "--width", "64", "--height",
                "48", "--pipeline", "closed-loop", "--mode-search", "-o", out,
                "--bitstream", bits])
    torch_main(["--device", "cpu", "decode", bits, "-o", dec])
    assert "Decoded: " in capsys.readouterr().out
    with open(src, "rb") as f:
        frame = Frame.from_yuv420p(f.read(), 48, 64)
    recon, want = encode_frame_closed_loop(
        frame, EncoderConfig(mode_set="all", decision="satd"), device="cpu")
    with open(bits, "rb") as f:
        assert f.read() == want
    with open(out, "rb") as f, open(dec, "rb") as g:
        assert f.read() == g.read() == recon.to_yuv420p()


def test_decode_corrupt_stream_errors(capsys, tmp_path):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x00\x00\x01garbage")
    with pytest.raises(SystemExit) as exc:
        torch_main(["--device", "cpu", "decode", str(bad), "-o",
                    str(tmp_path / "d.yuv")])
    assert exc.value.code == 1
    assert "Error:" in capsys.readouterr().err


def test_short_file_errors(capsys, tmp_path):
    src = tmp_path / "short.yuv"
    src.write_bytes(b"\x00" * 10)
    with pytest.raises(SystemExit) as exc:
        torch_main(["--device", "cpu", "encode", str(src), "--width", "64",
                    "--height", "64"])
    assert exc.value.code == 1
    assert "too small" in capsys.readouterr().out


def test_cuda_without_card_fails(capsys, monkeypatch, yuv_input):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmp, src = yuv_input
    out = tmp / "never.yuv"
    with pytest.raises(SystemExit) as exc:
        torch_main(["encode", src, "--width", "64", "--height", "48",
                    "--pipeline", "full", "-o", str(out)])
    assert exc.value.code == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not out.exists()


def test_module_entry_point():
    proc = subprocess.run(
        [sys.executable, "-m", "nanohevc_tpu_torch", "--device", "cpu",
         "demo", "--width", "16", "--height", "16", "--block-size", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "PSNR" in proc.stdout


# --- encode-seq, sequence decode, --target-bytes ----------------------------

def _timing_free(text: str) -> str:
    """stdout without the wall-clock lines (throughput, stage seconds)."""
    return "".join(line for line in text.splitlines(keepends=True)
                   if "Throughput:" not in line and " calls" not in line)


@pytest.fixture
def yuv_sequence(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 5 * 64 * 32 * 3 // 2, dtype=np.uint8)
    src = tmp_path / "seq.yuv"
    src.write_bytes((data // 4 + 96).astype(np.uint8).tobytes())
    return tmp_path, str(src)


@pytest.mark.parametrize("extra", [
    [],
    ["--closed-loop", "--qp", "27"],
    ["--target-bpp", "1.5", "--qp", "18"],
    ["--no-resume", "--entropy-tiles", "2", "--block-size", "16"],
    ["--closed-loop", "--target-bpp", "1.2", "--scan", "mode",
     "--dequant-rescale"],
])
def test_encode_seq_identical(capsys, yuv_sequence, extra):
    """Two runs each (4 frames, then resumed to 5): stdout, bitstream
    and sidecar equal the JAX CLI's."""
    tmp, src = yuv_sequence
    bits = str(tmp / "seq.bin")
    results = []
    for run, flag in ((jax_main, ["--platform", "cpu"]),
                      (torch_main, ["--device", "cpu"])):
        for path in (bits, bits + ".progress"):
            if os.path.exists(path):
                os.remove(path)
        for frames in ("4", "5"):
            run(flag + ["encode-seq", src, "--width", "64", "--height", "32",
                        "--frames", frames, "--batch", "2", "--bitstream",
                        bits] + extra)
        with open(bits, "rb") as f, open(bits + ".progress") as g:
            results.append((_timing_free(capsys.readouterr().out),
                            f.read(), g.read()))
    assert results[1] == results[0]
    out = results[1][0]
    assert "Frames: 5" in out and "Mean Y-PSNR" in out
    resumed = "--no-resume" not in extra
    assert ("Resumed from frame 4" in out) == resumed


def test_sequence_decode_identical(capsys, yuv_sequence):
    """`decode` of a closed-loop sequence: the JAX CLI and the port give
    the same text and YUV, and the YUV is the encoder's recon."""
    from nanohevc_tpu_torch.config import EncoderConfig
    from nanohevc_tpu_torch.frame import Frame
    from nanohevc_tpu_torch.models.wavefront import encode_frame_closed_loop

    tmp, src = yuv_sequence
    bits, dec = str(tmp / "seq.bin"), str(tmp / "dec.yuv")
    torch_main(["--device", "cpu", "encode-seq", src, "--width", "64",
                "--height", "32", "--frames", "5", "--batch", "4",
                "--closed-loop", "--bitstream", bits])
    capsys.readouterr()
    (jout, jf), (tout, tf) = _run_both(capsys, ["decode", bits, "-o", dec],
                                       outputs=[dec])
    assert tout == jout
    assert tf == jf
    assert "(5 frames)" in tout
    with open(src, "rb") as f:
        raw = f.read()
    fs = 64 * 32 * 3 // 2
    recon = b"".join(
        encode_frame_closed_loop(
            Frame.from_yuv420p(raw[i * fs:(i + 1) * fs], 32, 64),
            EncoderConfig(), device="cpu")[0].to_yuv420p()
        for i in range(5))
    assert tf[dec] == recon


@pytest.mark.parametrize("pipeline", ["full", "closed-loop"])
def test_encode_target_bytes_identical(capsys, yuv_input, pipeline):
    tmp, src = yuv_input
    out, bits = str(tmp / "out.yuv"), str(tmp / "out.bin")
    (jout, jf), (tout, tf) = _run_both(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "--pipeline", pipeline, "--target-bytes", "1500", "-o", out,
                 "--bitstream", bits], outputs=[out, bits])
    assert tout == jout
    assert tf == jf
    assert "Rate search: QP" in tout
    assert len(tf[bits]) <= 1500


def test_target_bytes_needs_a_bitstream(capsys, yuv_input):
    _, src = yuv_input
    for run, flag in ((jax_main, ["--platform", "cpu"]),
                      (torch_main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            run(flag + ["encode", src, "--width", "64", "--height", "48",
                        "--target-bytes", "900"])
        assert exc.value.code == 1
        assert "--target-bytes needs a coded bitstream" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--rdo", "--sao-ctb"], ["--rdoq", "--deblock"], ["--deblock"], ["--sao"],
    ["--sao-ctb"], ["--sao-tile", "32"], ["--hevc-export", "x.hevc"],
    ["--hevc-mono"], ["--chroma-mode", "dc"],
    ["--decision", "rd", "--chroma-mode", "dc"],
])
def test_unported_encode_seq_flags_exit_2(capsys, yuv_sequence, argv):
    """The `encode-seq --closed-loop` flags the port once refused with
    rc 2: rc, stdout (without its wall-clock lines), stderr, bitstream,
    sidecar and export equal the JAX CLI's."""
    tmp, src = yuv_sequence
    bits, hevc = str(tmp / "seq.bin"), str(tmp / "x.hevc")
    argv = [hevc if a == "x.hevc" else a for a in argv]
    jax_run, port_run = _run_both_rc(
        capsys, ["encode-seq", src, "--width", "64", "--height", "32",
                 "--frames", "2", "--batch", "2", "--closed-loop",
                 "--bitstream", bits] + argv,
        outputs=[bits, bits + ".progress", hevc], timing_free=True)
    assert port_run == jax_run
    assert port_run[0] == 0 and port_run[3][bits]


def test_encode_seq_without_card_fails(capsys, monkeypatch, yuv_sequence):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmp, src = yuv_sequence
    bits = tmp / "never.bin"
    with pytest.raises(SystemExit) as exc:
        torch_main(["encode-seq", src, "--width", "64", "--height", "32",
                    "--frames", "2", "--bitstream", str(bits)])
    assert exc.value.code == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not bits.exists()
