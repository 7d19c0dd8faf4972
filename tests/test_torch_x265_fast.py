"""The port's frame API under x265's fast preset run intra-only (the
benchmark's `x265_fast_n8` configuration: the 35 modes by SATD with luma
reference smoothing, no RDOQ, deblocking, CTB SAO on 64x64 tiles, CABAC
on the mode-dependent scan) against the JAX package's, bit-exact, on
the CPU at a non-aligned geometry: recon and bytes equal at QP 37 and
22, the port's decoder gives the recon back, and the closed loop takes
the wavefront kernel's route (its plain version here) for all three
planes.
"""

import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from nanohevc_tpu.config import EncoderConfig as JaxConfig
from nanohevc_tpu.frame import Frame as JaxFrame
from nanohevc_tpu.frame import Plane as JaxPlane
from nanohevc_tpu.models import wavefront as jax_wf
from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.frame import Frame, Plane
from nanohevc_tpu_torch.models import wavefront as torch_wf

CONFIG = Path(__file__).resolve().parent.parent / "benchmark" / "configs" / \
    "x265_fast_n8.json"
SETTINGS = json.loads(CONFIG.read_text())["encoder"]
# Neither plane kind is block-aligned: 38x50 luma at N=8, 19x25 chroma
# at N=4.
SHAPE = (38, 50)
QPS = (37, 22)


def make_planes(h, w, seed):
    """(y, u, v) int16: a ramp with flat and noisy patches, so that the
    search meets smooth and textured blocks."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw):
        yy, xx = np.mgrid[0:ph, 0:pw]
        base = (yy * 5 + xx * 3 + 40 * np.sin(xx / 5.0)).astype(np.int64)
        noise = rng.integers(-12, 13, (ph, pw))
        flat = np.kron(rng.random((ph // 8 + 1, pw // 8 + 1)) < 0.3,
                       np.ones((8, 8), bool))[:ph, :pw]
        return np.clip(np.where(flat, 128, base + noise), 0, 255).astype(
            np.int16)

    return plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)


@lru_cache(maxsize=None)
def codec(qp):
    planes = make_planes(*SHAPE, qp)
    jr, jb = jax_wf.encode_frame_closed_loop(
        JaxFrame(*(JaxPlane(p) for p in planes)), JaxConfig(**SETTINGS, qp=qp))
    tr, tb = torch_wf.encode_frame_closed_loop(
        Frame(*(Plane(p) for p in planes)), EncoderConfig(**SETTINGS, qp=qp),
        device="cpu")
    return jr, jb, tr, tb


def same_frames(a, b):
    return all(np.array_equal(getattr(a, p).data, getattr(b, p).data)
               for p in ("y", "u", "v"))


@pytest.mark.parametrize("qp", QPS)
def test_encode_frame_equals_jax(qp):
    jr, jb, tr, tb = codec(qp)
    assert tb == jb
    assert same_frames(tr, jr)


@pytest.mark.parametrize("qp", QPS)
def test_decode_frame_gives_the_recon(qp):
    _, _, tr, tb = codec(qp)
    assert same_frames(torch_wf.decode_frame(tb, device="cpu"), tr)


def test_every_plane_takes_the_wavefront_route(monkeypatch):
    _, _, tr, tb = codec(37)
    calls = []
    orig = torch_wf.wavefront_encode_planes

    def search(planes, qp, n, **kw):
        calls.append((planes.shape[0], n, kw["mode_set"], kw["decision"],
                      kw["intra_smoothing"], kw["rdoq"]))
        return orig(planes, qp, n, **kw)

    def refused(*args, **kwargs):
        raise AssertionError("the RD route was taken")

    monkeypatch.setattr(torch_wf, "wavefront_encode_planes", search)
    monkeypatch.setattr(torch_wf, "wavefront_rd_encode_planes", refused)
    recon, bits = torch_wf.encode_frame_closed_loop(
        Frame(*(Plane(p) for p in make_planes(*SHAPE, 37))),
        EncoderConfig(**SETTINGS, qp=37), device="cpu")
    assert bits == tb and same_frames(recon, tr)
    # Luma, then U and V as one batch of two.
    assert calls == [(1, 8, "all", "satd", True, False),
                     (2, 4, "all", "satd", False, False)]
