"""The check fails what it must.  The harness runs on the CPU at a small
size (the look for a card skipped) with the timed path broken
underneath, once for each fault a frame cell can have, and `correct`
comes out false; the sound run comes out true.  The control, the
reference with its RD costs in bfloat16 in the program's place, fails
the check of every cell.  (The exchange between chips is no fault of
these one-chip cells.)"""

import json

import pytest

from conftest import BENCH, ROOT, SMALL
import control
import run

WF = "nanohevc_tpu_torch.models.wavefront"
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run_small(cell="ctc_ai_n8.frame.qp37", seed=11):
    return run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "0.5"], device="cpu", overrides=SMALL)


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


def level_altered(monkeypatch):
    """A level altered where the RD kernel produces it."""
    from nanohevc_tpu_torch.models import wavefront
    orig = wavefront.wavefront_rd_encode_planes

    def faulty(*args, **kwargs):
        out = orig(*args, **kwargs)
        out["levels"].view(-1)[5] += 1
        return out
    monkeypatch.setattr(wavefront, "wavefront_rd_encode_planes", faulty)


def half_left_out(monkeypatch):
    """The RD kernel codes the first half of a plane's blocks and leaves
    the rest."""
    from nanohevc_tpu_torch.models import wavefront
    orig = wavefront.wavefront_rd_encode_planes

    def faulty(*args, **kwargs):
        out = orig(*args, **kwargs)
        nb = out["modes"].shape[1]
        out["levels"][:, nb // 2:] = 0
        out["modes"][:, nb // 2:] = 1
        out["recon"][:, out["recon"].shape[1] // 2:] = 0
        return out
    monkeypatch.setattr(wavefront, "wavefront_rd_encode_planes", faulty)


def state_unchanged(monkeypatch):
    """A frame call that returns the previous call's result."""
    from nanohevc_tpu_torch.models import wavefront
    orig = wavefront.encode_frame_closed_loop
    last = []

    def faulty(*args, **kwargs):
        if not last:
            last.append(orig(*args, **kwargs))
        return last[0]
    monkeypatch.setattr(wavefront, "encode_frame_closed_loop", faulty)


def byte_altered(monkeypatch):
    """The bitstream writer alters a byte of the levels' payload."""
    from nanohevc_tpu_torch.runtime import bitstream
    orig = bitstream.assemble_bitstream

    def faulty(*args, **kwargs):
        out = bytearray(orig(*args, **kwargs))
        out[-2] ^= 0x10
        return bytes(out)
    monkeypatch.setattr(bitstream, "assemble_bitstream", faulty)


@pytest.mark.parametrize("fault", [level_altered, half_left_out,
                                   state_unchanged, byte_altered])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run_small()
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    checks = control.run_control(cell, 21, "cpu", SMALL)
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check_on_the_card(cell, cuda_card):
    big = {"height": 270, "width": 480, "frames": 2, "frames_checked": 2,
           "streams_checked": 1}
    checks = control.run_control(cell, 22, cuda_card, big)
    assert any(v > lim for _, v, lim in checks), checks
