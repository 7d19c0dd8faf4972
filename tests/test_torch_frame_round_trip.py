"""The closed-loop frame call's one round trip to the device
(`models/wavefront.py::encode_frame_closed_loop`: the planes up in one
copy in their own dtype, luma as one plane call, U and V as one batch,
one wait) against the plane-by-plane composition it replaced, done
here: each plane through `encode_plane_closed_loop` on its own, then
`assemble_bitstream`.  Recon, levels, modes, SAO parameters and bytes
must be equal under the benchmark's three configurations, per-frame
SAO, 10 bits, a geometry that is not block-aligned, and uint8 and int16
planes.  What the call returns and hands the bitstream writer is its
own: a later call leaves it as it was, and none of it is a view of a
torch tensor (staging, which the allocator hands out again)."""

import copy

import numpy as np
import pytest
import torch

from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.frame import Frame, Plane
from nanohevc_tpu_torch.models import wavefront as wf
from nanohevc_tpu_torch.runtime import bitstream

FILTERS = dict(entropy_coder="cabac", deblock=True, sao_ctb=True, sao_tile=16)
# The benchmark's cells (RD over 35 modes with RDOQ, smoothing and CTB SAO
# at N=8; the same at N=4 with DST; x265's SATD search over 35 modes),
# per-frame SAO, and 10 bits.
CONFIGS = {
    "rd_n8": dict(FILTERS, block_size=8, mode_set="all", decision="rd",
                  scan="mode", rdoq=True, intra_smoothing=True,
                  dequant_rescale=True),
    "rd_n4_dst": dict(FILTERS, block_size=4, mode_set="all", decision="rd",
                      scan="mode", rdoq=True, intra_smoothing=True,
                      dequant_rescale=True),
    "satd_n8": dict(FILTERS, block_size=8, mode_set="all", decision="satd",
                    scan="mode", intra_smoothing=True, dequant_rescale=True),
    "frame_sao": dict(entropy_coder="cabac", deblock=True, sao=True),
    "10bit": dict(FILTERS, bit_depth=10, mode_set="all", decision="sad"),
}
CASES = [
    ("rd_n8", np.int16, (36, 52)), ("rd_n8", np.uint8, (32, 48)),
    ("rd_n4_dst", np.int16, (36, 52)), ("rd_n4_dst", np.uint8, (36, 52)),
    ("satd_n8", np.int16, (32, 48)), ("satd_n8", np.uint8, (36, 52)),
    ("frame_sao", np.uint8, (36, 52)), ("frame_sao", np.int16, (32, 48)),
    ("10bit", np.int16, (36, 52)),
]


def make_frame(h: int, w: int, dtype, bit_depth: int, seed: int) -> Frame:
    """Ramps with seeded noise, so that the blocks take several modes."""
    rng = np.random.default_rng(seed)
    top = (1 << bit_depth) - 1

    def plane(ph, pw):
        ramp = np.add.outer(np.arange(ph) * 7, np.arange(pw) * 3)
        noise = rng.integers(0, top // 8 + 1, (ph, pw))
        return Plane(((ramp * top // max(ramp.max(), 1) + noise) % (top + 1))
                     .astype(dtype))

    return Frame(plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2))


class Writer:
    """Stands for the bitstream writer the frame call looks up at call
    time, keeping what each call hands it."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return ORIGINAL(*args, **kwargs)


ORIGINAL = bitstream.assemble_bitstream


@pytest.fixture
def writer(monkeypatch):
    w = Writer()
    monkeypatch.setattr(bitstream, "assemble_bitstream", w)
    return w


def composed(frame: Frame, config: EncoderConfig) -> tuple:
    """The frame plane by plane: (recon planes, levels, modes, SAO
    parameters, bytes), as the frame call computed them before."""
    recon, levels, modes, sao = {}, {}, {}, {}
    for name, p in zip("YUV", (frame.y, frame.u, frame.v)):
        args = wf.plane_args(config, name == "Y")
        out = wf.encode_plane_closed_loop(
            torch.from_numpy(p.data.astype(np.int32)), config.qp, **args)
        got = {k: tuple(a.numpy() for a in v) if isinstance(v, tuple)
               else v.numpy() for k, v in out.items()}
        recon[name] = got["recon"].astype(np.int16)
        levels[name] = (got["levels"], args["n"])
        modes[name] = got["modes"]
        if config.sao:
            t, pos, offs = got["sao"]
            sao[name] = (int(t), int(pos), offs)
        if config.sao_ctb:
            sao[name] = (config.sao_tile,) + got["sao_ctb"]
    bits = ORIGINAL(
        frame.width, frame.height, config.qp, levels, modes,
        bit_depth=config.bit_depth, scan=config.scan,
        dequant_rescale=config.dequant_rescale,
        intra_smoothing=config.intra_smoothing,
        entropy_coder=config.entropy_coder, deblock=config.deblock,
        sao=sao if config.sao else None,
        sao_ctb=sao if config.sao_ctb else None)
    return recon, levels, modes, sao, bits


def handed(call) -> tuple:
    """(levels, modes, SAO parameters) of one call of the writer."""
    args, kwargs = call
    return args[3], args[4], kwargs["sao"] or kwargs["sao_ctb"]


def assert_same_params(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_params(g, w)
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want))


def test_every_case_is_covered():
    assert {c for c, _, _ in CASES} == set(CONFIGS)
    assert {d for _, d, _ in CASES} == {np.uint8, np.int16}
    assert any(h % 8 or w % 8 for _, _, (h, w) in CASES)


@pytest.mark.parametrize("name,dtype,shape", CASES,
                         ids=[f"{c}-{np.dtype(d).name}-{h}x{w}"
                              for c, d, (h, w) in CASES])
def test_frame_call_equals_planes_one_by_one(writer, name, dtype, shape):
    config = EncoderConfig(qp=27, **CONFIGS[name])
    frame = make_frame(*shape, dtype, config.bit_depth, seed=len(name))
    recon, bits = wf.encode_frame_closed_loop(frame, config, device="cpu")
    levels, modes, sao = handed(writer.calls[-1])
    want_recon, want_levels, want_modes, want_sao, want_bits = composed(
        frame, config)
    assert bits == want_bits
    for p, plane in zip("YUV", (recon.y, recon.u, recon.v)):
        assert plane.data.dtype == np.int16
        assert np.array_equal(plane.data, want_recon[p])
        assert levels[p][1] == want_levels[p][1]
        assert np.array_equal(levels[p][0], want_levels[p][0])
        assert np.array_equal(modes[p], want_modes[p])
        assert_same_params(sao[p], want_sao[p])


def torch_backed(a) -> bool:
    """Whether numpy array `a` is a view of a torch tensor's memory."""
    while a is not None:
        if isinstance(a, torch.Tensor):
            return True
        a = getattr(a, "base", None)
    return False


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from leaves(v)
    elif isinstance(tree, np.ndarray):
        yield tree


@pytest.mark.parametrize("name", ["rd_n8", "frame_sao"])
def test_outputs_are_the_calls_own(writer, name):
    """A second call with another frame leaves the first call's recon and
    the arrays its writer received as they were."""
    config = EncoderConfig(qp=32, **CONFIGS[name])
    first, second = (make_frame(36, 52, np.int16, 8, seed=s) for s in (5, 6))
    recon, _ = wf.encode_frame_closed_loop(first, config, device="cpu")
    given = handed(writer.calls[-1])
    kept = copy.deepcopy((recon.y.data, recon.u.data, recon.v.data, given))
    other, _ = wf.encode_frame_closed_loop(second, config, device="cpu")
    assert not np.array_equal(other.y.data, kept[0])
    now = (recon.y.data, recon.u.data, recon.v.data, given)
    for a, b in zip(leaves(now), leaves(kept), strict=True):
        assert np.array_equal(a, b)
        assert not torch_backed(a)
