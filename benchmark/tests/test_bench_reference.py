"""The plain reference against the port's CPU path on a small frame of
each configuration: recon, levels, modes, CTB SAO parameters and bytes
equal, and the port's decoder gives the recon back from those bytes."""

import json

import numpy as np
import pytest

from conftest import BENCH
from benchlib import traffic
from plainref import bitstream, encoder

from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.frame import Frame, Plane
from nanohevc_tpu_torch.models import wavefront
from nanohevc_tpu_torch.runtime import bitstream as port_bitstream


def config(name, qp):
    return dict(json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "encoder"], qp=qp)


@pytest.mark.parametrize("name,qp,noise", [("ctc_ai_n8", 37, 2),
                                           ("ctc_ai_n8", 22, 8),
                                           ("ctc_ai_n4", 37, 2),
                                           ("ctc_ai_n4", 27, 8)])
def test_reference_equals_the_port_on_the_cpu(name, qp, noise, monkeypatch):
    settings = config(name, qp)
    h, w = 64, 132                 # pads to 8 and to 4 on both planes
    frames = traffic.make_frames(99, 2, h, w, noise)
    ref = encoder.encode_frames(frames, settings, "cpu")
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


def test_reference_refuses_what_it_does_not_cover():
    settings = dict(config("ctc_ai_n8", 37), decision="satd")
    with pytest.raises(ValueError):
        encoder.encode_frames(traffic.make_frames(1, 1, 16, 16, 2), settings,
                              "cpu")


def test_range_coder_and_hash_against_the_port():
    from nanohevc_tpu_torch.runtime import entropy

    rng = np.random.default_rng(4)
    for nby, nbx in ((1, 1), (3, 5), (17, 9)):
        modes = rng.integers(0, 35, nby * nbx).astype(np.int32)
        modes[::3] = 1
        assert bitstream.encode_modes(modes, nby, nbx) == entropy.encode_modes(
            modes, nby, nbx)
    for payload in (b"", b"\x00\x00\x01\x00\x00\x00\x03", bytes(range(256))):
        assert bitstream.wrap_nal(1, payload) == entropy.wrap_nal(1, payload)
