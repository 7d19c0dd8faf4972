"""`python -m nanohevc_tpu_torch` vs `python -m nanohevc_tpu`.

For the same arguments (the port with --device cpu, the JAX CLI with
--platform cpu) stdout and the files written must be identical, for
`demo`, `encode` (predict, full and closed-loop pipelines) and
`decode`.  Flags the port does not cover yet exit with rc 2; a missing
card fails instead of running on the CPU.
"""

import os
import subprocess
import sys

import pytest

import torch

from nanohevc_tpu.cli import main as jax_main
from nanohevc_tpu_torch.cli import main as torch_main
from nanohevc_tpu_torch.models.all_intra import create_test_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    ["--rdo"], ["--rdoq"],
    ["--deblock"], ["--sao"], ["--sao-ctb"], ["--sao-tile", "32"],
    ["--hevc-export", "x.hevc"], ["--hevc-mono"], ["--chroma-mode", "dc"],
    ["--target-bytes", "1000"], ["--pipeline", "closed-loop", "--deblock"],
    ["--decision", "rd"],
])
def test_unported_encode_flags_exit_2(capsys, yuv_input, argv):
    _, src = yuv_input
    with pytest.raises(SystemExit) as exc:
        torch_main(["--device", "cpu", "encode", src, "--width", "64",
                    "--height", "48", "--pipeline", "full"] + argv)
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def _sequence_stream(frame) -> bytes:
    """Two closed-loop frames behind access-unit delimiters (NAL type
    35), the layout of the JAX package's sequence streams."""
    import struct

    from nanohevc_tpu_torch.config import EncoderConfig
    from nanohevc_tpu_torch.models.wavefront import encode_frame_closed_loop
    from nanohevc_tpu_torch.runtime.entropy import wrap_nal

    _, bits = encode_frame_closed_loop(frame, EncoderConfig(), device="cpu")
    return b"".join(wrap_nal(35, struct.pack("<I", i)) + bits for i in range(2))


@pytest.mark.parametrize("argv", [
    ["encode-seq", "in.yuv", "--width", "64", "--height", "48",
     "--frames", "2", "--bitstream", "o.bin"],
    ["--device", "cpu", "decode", "{sequence}", "-o", "{out}"],
    ["--platform", "cpu", "demo"],
])
def test_unported_commands_exit_2(capsys, tmp_path, argv):
    seq, out = tmp_path / "seq.bin", tmp_path / "d.yuv"
    seq.write_bytes(_sequence_stream(create_test_frame(16, 32)))
    argv = [a.format(sequence=seq, out=out) for a in argv]
    with pytest.raises(SystemExit) as exc:
        torch_main(argv)
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not out.exists()


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
