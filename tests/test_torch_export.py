"""The standard-syntax Annex B export (`--hevc-export`) of the port's
CLI vs the JAX CLI's.

`encode --pipeline closed-loop --hevc-export` (4:2:0 with the default
DC chroma mode or `--chroma-mode planar`, and `--hevc-mono`) and
`encode-seq --closed-loop --hevc-export` must write the JAX CLI's
stream byte for byte, beside the same container bitstream and text;
the export's refusals (in-loop filters, the open loop, 4x4 blocks) must
give the JAX CLI's rc and text.  Both CLIs run on the CPU.
"""

import os

import numpy as np
import pytest

from nanohevc_tpu.cli import main as jax_main
from nanohevc_tpu_torch.cli import main as torch_main
from nanohevc_tpu_torch.models.all_intra import create_test_frame
from nanohevc_tpu_torch.runtime import hevc_stream


def run_both(capsys, args, outputs):
    """(rc, stdout, stderr, files) of the JAX CLI and of the port's;
    wall-clock lines dropped from stdout."""
    results = []
    for run, flag in ((jax_main, ["--platform", "cpu"]),
                      (torch_main, ["--device", "cpu"])):
        for path in outputs:
            if os.path.exists(path):
                os.remove(path)
        try:
            run(flag + args)
            rc = 0
        except SystemExit as e:
            rc = e.code
        except ValueError as e:
            rc = ("ValueError", str(e))
        out, err = capsys.readouterr()
        out = "".join(line for line in out.splitlines(True)
                      if "Throughput:" not in line and " calls" not in line)
        files = {p: open(p, "rb").read() if os.path.exists(p) else None
                 for p in outputs}
        results.append((rc, out, err, files))
    return results


@pytest.fixture
def frame_file(tmp_path):
    rng = np.random.default_rng(11)
    frame = create_test_frame(48, 64)
    for p in (frame.y, frame.u, frame.v):
        p.data[...] = np.clip(p.data + rng.integers(-6, 7, p.data.shape),
                              0, 255)
    src = tmp_path / "in.yuv"
    src.write_bytes(frame.to_yuv420p())
    return tmp_path, str(src)


ENCODE_CASES = {
    "420-dc": [],
    "420-planar": ["--chroma-mode", "planar", "--qp", "30"],
    "420-dc-explicit-16": ["--chroma-mode", "dc", "--block-size", "16",
                           "--scan", "mode"],
    "mono": ["--hevc-mono"],
    "mono-sad-search": ["--hevc-mono", "--mode-search", "--decision", "sad"],
}


@pytest.mark.parametrize("name", ENCODE_CASES)
def test_encode_export_identical(capsys, frame_file, name):
    tmp, src = frame_file
    out, bits, hevc = (str(tmp / f) for f in ("o.yuv", "o.bin", "o.hevc"))
    jax_run, port_run = run_both(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "--pipeline", "closed-loop", "-o", out, "--bitstream", bits,
                 "--hevc-export", hevc] + ENCODE_CASES[name],
        [out, bits, hevc])
    assert port_run == jax_run
    rc, text, _, files = port_run
    assert rc == 0 and "HEVC export (" in text
    assert files[hevc].startswith(b"\x00\x00\x00\x01")      # Annex B
    assert ("fixed DC mode" in text) == (name == "420-dc")


REFUSED = {
    "deblock": ["--pipeline", "closed-loop", "--deblock"],
    "sao+sao-ctb": ["--pipeline", "closed-loop", "--sao", "--sao-ctb"],
    "full-pipeline": ["--pipeline", "full"],
    "predict": [],
    "4x4-blocks": ["--pipeline", "closed-loop", "--block-size", "4"],
}


@pytest.mark.parametrize("name", REFUSED)
def test_encode_export_refusals_identical(capsys, frame_file, name):
    tmp, src = frame_file
    bits, hevc = str(tmp / "o.bin"), str(tmp / "o.hevc")
    jax_run, port_run = run_both(
        capsys, ["encode", src, "--width", "64", "--height", "48",
                 "--bitstream", bits, "--hevc-export", hevc] + REFUSED[name],
        [bits, hevc])
    assert port_run == jax_run
    assert port_run[0] != 0 and port_run[3][hevc] is None


@pytest.fixture
def sequence_file(tmp_path):
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, 3 * 64 * 32 * 3 // 2, dtype=np.uint8)
    src = tmp_path / "seq.yuv"
    src.write_bytes((data // 4 + 96).astype(np.uint8).tobytes())
    return tmp_path, str(src)


SEQUENCE_CASES = {
    "420": ["--closed-loop"],
    "420-rate-control": ["--closed-loop", "--target-bpp", "1.2"],
    "mono": ["--closed-loop", "--hevc-mono", "--qp", "30"],
    "open-loop": [],
    "filter": ["--closed-loop", "--sao"],
}


@pytest.mark.parametrize("name", SEQUENCE_CASES)
def test_encode_seq_export_identical(capsys, sequence_file, name):
    """3 frames at batch 2: export (one IDR access unit a frame, each
    at its slice QP), bitstream, sidecar and text, or the refusal."""
    tmp, src = sequence_file
    bits, hevc = str(tmp / "s.bin"), str(tmp / "s.hevc")
    jax_run, port_run = run_both(
        capsys, ["encode-seq", src, "--width", "64", "--height", "32",
                 "--frames", "3", "--batch", "2", "--bitstream", bits,
                 "--hevc-export", hevc] + SEQUENCE_CASES[name],
        [bits, bits + ".progress", hevc])
    assert port_run == jax_run
    rc, text, _, files = port_run
    if name in ("open-loop", "filter"):
        assert rc == 1 and files[hevc] is None and files[bits] is None
    else:
        assert rc == 0 and "3 IDR AUs" in text


def test_export_copy_is_the_original():
    """The writer the CLI uses is the port's copy, whose slice coder is
    the port's native runtime."""
    src = open(hevc_stream.__file__).read()
    assert "nanohevc_tpu_torch.runtime.hevc import" in src
    assert "from nanohevc_tpu." not in src
