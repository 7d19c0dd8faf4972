"""The search reference (`plainref/search.py`) against the port's CPU path
on small frames of `x265_fast_n8` and of the other per-block decisions
it covers: recon, levels, modes, CTB SAO parameters and bytes equal, and
the port's decoder gives the recon back from those bytes.  Then the
`frame_search` entry on a tiny frame: its spans, its check, and the
reference it puts in `plainref.encoder`'s place only while it lives."""

import json

import numpy as np
import pytest

from conftest import BENCH, SMALL
from benchlib import spec, traffic
from plainref import bitstream, encoder, search

from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.frame import Frame, Plane
from nanohevc_tpu_torch.models import wavefront
from nanohevc_tpu_torch.runtime import bitstream as port_bitstream

CELL = "x265_fast_n8.frame.qp37"


def config(qp, **changes):
    return dict(json.loads((BENCH / "configs" / "x265_fast_n8.json")
                           .read_text())["encoder"], qp=qp, **changes)


@pytest.mark.parametrize("qp,noise,changes", [
    (37, 2, {}), (22, 8, {}), (32, 4, {"block_size": 4}),
    (27, 4, {"block_size": 16, "decision": "sad"}),
    (30, 4, {"decision": "energy", "rdoq": True})])
def test_reference_equals_the_port_on_the_cpu(qp, noise, changes,
                                              monkeypatch):
    settings = config(qp, **changes)
    h, w = 64, 132                 # pads on every plane at every N
    frames = traffic.make_frames(98, 2, h, w, noise)
    ref = search.encode_frames(frames, settings, "cpu")
    seen = []
    orig = port_bitstream.assemble_bitstream

    def capture(*args, **kwargs):
        seen.append((args[3], args[4], kwargs["sao_ctb"]))
        return orig(*args, **kwargs)

    monkeypatch.setattr(port_bitstream, "assemble_bitstream", capture)
    for f, r in zip(frames, ref):
        recon, bits = wavefront.encode_frame_closed_loop(
            Frame(*(Plane(p) for p in f)), EncoderConfig(**settings),
            device="cpu")
        levels, modes, sao = seen[-1]
        for p, plane in zip("YUV", (recon.y, recon.u, recon.v)):
            assert np.array_equal(plane.data, r["recon"][p])
            assert levels[p][1] == r["levels"][p][1]
            assert np.array_equal(levels[p][0], r["levels"][p][0])
            assert np.array_equal(modes[p], r["modes"][p])
            for a, b in zip(sao[p], r["sao_ctb"][p]):
                assert np.array_equal(a, b)
        assert bits == bitstream.assemble(w, h, settings, r["levels"],
                                          r["modes"], r["sao_ctb"])
        back = wavefront.decode_frame(bits, device="cpu")
        for p, plane in zip("YUV", (back.y, back.u, back.v)):
            assert np.array_equal(plane.data, r["recon"][p])


@pytest.mark.parametrize("changes", [{"decision": "rd"},
                                     {"mode_set": "dc_planar"},
                                     {"chroma_mode_set": "dc_planar"},
                                     {"sao_ctb": False}])
def test_reference_refuses_what_it_does_not_cover(changes):
    with pytest.raises(ValueError):
        search.encode_frames(traffic.make_frames(1, 1, 16, 16, 2),
                             config(37, **changes), "cpu")


def test_entry_spans_check_and_reference(monkeypatch):
    import run

    kinds = []
    orig = search.encode_frames

    def counted(frames, cfg, device, *args):
        kinds.append(cfg["decision"])
        return orig(frames, cfg, device, *args)

    monkeypatch.setattr(search, "encode_frames", counted)
    before = encoder.encode_frames
    out = run.main(["--workload", CELL, "--seed", "3000000019", "--seconds",
                    "0.3", "--trace", "1"], device="cpu", overrides=SMALL)
    assert out["correct"] and out["failed"] == 0
    assert set(out["checks"]) == {"blocks_differing", "samples_differing",
                                  "sao_tiles_differing", "streams_differing"}
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert kinds == ["satd"]                 # the check ran the search
    assert encoder.encode_frames is before   # and put the RD one back
    # The card is idle on the CPU: its gaps lie under the entry's spans,
    # the search kernel's among them.
    assert "search_kernel" in dict(out["breakdown"]["idle_gaps"])


def test_entry_spans_are_the_frame_entrys_and_the_search_kernel():
    cell = spec.find_cell(CELL, BENCH.parent, BENCH)
    work = {**cell.config["frame"], **cell.workload, **SMALL}
    frames = traffic.make_frames(5, work["frames"], work["height"],
                                 work["width"], work["noise"])
    entry = spec.load_module("entries", "frame_search", BENCH).Entry(
        cell.config, work, frames, "cpu", 5)
    try:
        assert encoder.encode_frames is search.encode_frames
        base = spec.load_module("entries", "frame", BENCH).Entry.spans(entry)
        assert entry.spans() == base + [
            ("nanohevc_tpu_torch.models.wavefront", "wavefront_encode_planes",
             "search_kernel")]
    finally:
        entry.release()
    assert encoder.encode_frames is not search.encode_frames
