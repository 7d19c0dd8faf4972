"""The port's closed loop (wavefront encode and decoder) vs the JAX
package's, bit-exact.

Seeded numpy planes go through `nanohevc_tpu.models.wavefront` and
`nanohevc_tpu_torch.models.wavefront` on the CPU.  The JAX side runs
its XLA scan (`allow_fast=False`, which its own tests pin to its
Pallas kernels and to the sequential per-block oracle) or, where it is
quick on the CPU, its default path through the K4 kernel in interpret
mode.  Recon, scan-packed levels, modes, bitstream bytes and decoded
pixels must be equal; the tolerance is 0 everywhere.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.frame import Frame, Plane
from nanohevc_tpu.models import wavefront as jax_wf
from nanohevc_tpu.ops.tiling import extract_refs_at as jax_extract_refs_at
from nanohevc_tpu_torch import config as port_config
from nanohevc_tpu_torch import frame as port_frame_mod
from nanohevc_tpu_torch import ops
from nanohevc_tpu_torch.kernels import wavefront as kwf
from nanohevc_tpu_torch.models import wavefront as torch_wf
from nanohevc_tpu_torch.runtime.entropy import CorruptBitstreamError


def seeded_planes(b, h, w, seed, bit_depth=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bit_depth, (b, h, w)).astype(np.int32)


def port_cfg(cfg):
    return port_config.EncoderConfig(**dataclasses.asdict(cfg))


def port_frame(frame):
    return port_frame_mod.Frame(*(port_frame_mod.Plane(p.data)
                                  for p in (frame.y, frame.u, frame.v)))


def _assert_planes_equal(j, t):
    for k in ("recon", "levels", "modes"):
        want = np.asarray(j[k])
        got = t[k].numpy()
        assert got.dtype == np.int32, k
        assert got.shape == want.shape, k
        assert np.array_equal(got, want), k


def _both(planes, qp, allow_fast_jax=False, **kw):
    j = jax_wf.encode_planes_closed_loop(
        jnp.asarray(planes), jnp.int32(qp), allow_fast=allow_fast_jax, **kw)
    t = torch_wf.encode_planes_closed_loop(torch.from_numpy(planes), qp, **kw)
    return j, t


GRID = [
    # block sizes, DST at 4
    dict(n=4, use_dst=True),
    dict(n=4),
    dict(n=8),
    dict(n=16),
    dict(n=32, qp=30),
    # every mode set x decision the closed loop takes
    dict(n=8, decision="sad"),
    dict(n=8, decision="satd"),
    dict(n=8, mode_set="all", decision="energy"),
    dict(n=8, mode_set="all", decision="sad"),
    dict(n=8, mode_set="all", decision="satd"),
    dict(n=4, mode_set="all", decision="satd", use_dst=True),
    dict(n=16, mode_set="all", decision="satd", qp=35),
    dict(n=32, mode_set="all", decision="satd", qp=40),
    # luma smoothing, bit depth, dequant, scans
    dict(n=8, intra_smoothing=True),
    dict(n=16, mode_set="all", decision="satd", intra_smoothing=True),
    dict(n=32, mode_set="all", decision="sad", intra_smoothing=True),
    dict(n=8, bit_depth=10, qp=30),
    dict(n=4, mode_set="all", decision="satd", bit_depth=10,
         dequant_rescale=True, use_dst=True),
    dict(n=16, dequant_rescale=True, qp=37),
    dict(n=8, mode_set="all", decision="satd", scan="mode"),
    dict(n=4, scan="mode", qp=0),
    dict(n=8, mode_set="all", decision="satd", scan="horizontal", qp=51),
    # the fixed mode sets, and smoothing with RDOQ at N=32
    dict(n=8, mode_set="dc", bit_depth=10),
    dict(n=16, mode_set="planar", intra_smoothing=True),
    dict(n=32, mode_set="all", decision="energy", intra_smoothing=True,
         rdoq=True, qp=27),
]


def _grid_id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("kw", GRID, ids=_grid_id)
def test_closed_loop_matches_jax_scan(kw):
    """3x5-block planes against the JAX XLA scan."""
    kw = dict(kw)
    n, qp = kw.pop("n"), kw.pop("qp", 24)
    planes = seeded_planes(1, 3 * n, 5 * n, n + qp, kw.get("bit_depth", 8))
    _assert_planes_equal(*_both(planes, qp, n=n, **kw))


@pytest.mark.parametrize("shape,kw", [
    ((1, 8, 64), dict(n=8)),                                    # 1 x k
    ((1, 64, 8), dict(n=8, mode_set="all", decision="satd")),   # k x 1
    ((1, 4, 40), dict(n=4, mode_set="all", decision="satd", use_dst=True)),
    ((1, 52, 61), dict(n=8)),                                   # non-aligned
    ((1, 52, 61), dict(n=16, mode_set="all", decision="satd")),
    ((2, 24, 40), dict(n=8)),                                   # batch 2
    ((2, 40, 24), dict(n=4, mode_set="all", decision="satd")),
    ((2, 37, 45), dict(n=8, mode_set="all", decision="satd", bit_depth=10)),
], ids=lambda v: str(v) if isinstance(v, tuple) else _grid_id(v))
def test_closed_loop_geometry_matches_jax_scan(shape, kw):
    planes = seeded_planes(*shape, 7, kw.get("bit_depth", 8))
    _assert_planes_equal(*_both(planes, 27, **kw))


@pytest.mark.parametrize("n,h,w,kw", [
    (8, 24, 32, {}),
    (4, 16, 24, dict(use_dst=True)),
    (16, 48, 64, dict(bit_depth=10, dequant_rescale=True)),
])
def test_dc_planar_matches_jax_kernel(n, h, w, kw):
    """DC/planar at batch 1 against JAX's default path, its K4 Pallas
    kernel (interpret mode on the CPU)."""
    planes = seeded_planes(1, h, w, 5, kw.get("bit_depth", 8))
    _assert_planes_equal(*_both(planes, 24, allow_fast_jax=None, n=n, **kw))


@pytest.mark.slow
def test_mode_search_matches_jax_kernel():
    """The 35-mode search against JAX's K3a/K3b Pallas kernels
    (interpret mode on the CPU, compile-bound)."""
    planes = seeded_planes(2, 24, 40, 9)
    _assert_planes_equal(*_both(planes, 28, allow_fast_jax=True, n=8,
                                mode_set="all", decision="satd"))


@pytest.mark.parametrize("h,w,n", [(24, 40, 8), (8, 32, 4), (64, 16, 16),
                                   (32, 32, 32), (21, 35, 4)])
def test_extract_refs_at_matches_jax(h, w, n):
    rng = np.random.default_rng(h * w + n)
    plane = rng.integers(0, 1024, (h, w)).astype(np.int32)
    ys = rng.integers(0, h // n, 9)
    xs = rng.integers(0, w // n, 9)
    want = np.asarray(jax_extract_refs_at(jnp.asarray(plane), jnp.asarray(ys),
                                          jnp.asarray(xs), n, boundary=512))
    got = ops.extract_refs_at(torch.from_numpy(plane), torch.from_numpy(ys),
                              torch.from_numpy(xs), n, boundary=512)
    assert np.array_equal(got.numpy(), want)
    batched = ops.extract_refs_at(torch.from_numpy(np.stack([plane, plane])),
                                  torch.from_numpy(ys), torch.from_numpy(xs),
                                  n, boundary=512)
    assert np.array_equal(batched[1].numpy(), want)


def test_extract_refs_at_availability_rule():
    """On a zero-filled recon written one diagonal at a time, the
    extensions of an interior block read 0 and the last block-column
    replicates T[N]."""
    n = 4
    recon = torch.zeros((12, 16), dtype=torch.int32)
    recon[:4, :8] = 7                    # blocks (0, 0) and (0, 1): diagonals 0, 1
    recon[:4, 8:12] = 9                  # block (0, 2): diagonal 2
    refs = ops.extract_refs_at(recon, torch.tensor([1]), torch.tensor([1]), n)
    top = refs[0, :2 * n + 1]
    assert top[1:n + 1].tolist() == [7] * n
    assert top[n + 1:].tolist() == [9] * n   # diagonal 2 written: would read 9
    recon[:4, 8:12] = 0                      # ... but diagonal 2 is not yet
    refs = ops.extract_refs_at(recon, torch.tensor([1]), torch.tensor([1]), n)
    assert refs[0, n + 1:2 * n + 1].tolist() == [0] * n
    recon[:4, 12:16] = 5                     # block (0, 3), last column
    refs = ops.extract_refs_at(recon, torch.tensor([1]), torch.tensor([3]), n)
    assert refs[0, n + 1:2 * n + 1].tolist() == [5] * n


@pytest.mark.parametrize("kw", [
    dict(n=8),
    dict(n=4, use_dst=True, scan="mode"),
    dict(n=8, mode_set="all", decision="satd"),
    dict(n=16, mode_set="all", decision="satd", intra_smoothing=True,
         bit_depth=10, dequant_rescale=True),
    dict(n=32, mode_set="all", decision="energy", intra_smoothing=True),
], ids=_grid_id)
@pytest.mark.parametrize("shape", [(2, 40, 48), (1, 37, 70)])
def test_decode_reproduces_recon(kw, shape):
    kw = dict(kw)
    n = kw.pop("n")
    planes = seeded_planes(*shape, 11, kw.get("bit_depth", 8))
    enc = torch_wf.encode_planes_closed_loop(torch.from_numpy(planes), 30,
                                             n=n, **kw)
    dec_kw = {k: v for k, v in kw.items() if k not in ("mode_set", "decision")}
    dec = torch_wf.decode_planes(enc["levels"], enc["modes"], [30] * shape[0],
                                 n=n, height=shape[1], width=shape[2], **dec_kw)
    assert torch.equal(dec, enc["recon"])
    one = torch_wf.decode_plane(enc["levels"][0], enc["modes"][0], 30, n=n,
                                height=shape[1], width=shape[2], **dec_kw)
    assert torch.equal(one, enc["recon"][0])


def test_decode_plane_matches_jax():
    planes = seeded_planes(1, 40, 56, 12)
    enc = torch_wf.encode_plane_closed_loop(torch.from_numpy(planes[0]), 26,
                                            n=8, mode_set="all",
                                            decision="satd", scan="mode")
    want = jax_wf.decode_plane(jnp.asarray(enc["levels"].numpy()),
                               jnp.asarray(enc["modes"].numpy()),
                               jnp.int32(26), n=8, height=40, width=56,
                               scan="mode")
    got = torch_wf.decode_plane(enc["levels"], enc["modes"], 26, n=8,
                                height=40, width=56, scan="mode")
    assert np.array_equal(got.numpy(), np.asarray(want))


def make_frame(h, w, seed, bit_depth=8):
    rng = np.random.default_rng(seed)
    peak = (1 << bit_depth) - 1

    def plane(ph, pw):
        yy, xx = np.mgrid[0:ph, 0:pw]
        ramp = (yy * 3 + xx * 2) % (peak + 1)
        noise = rng.integers(-12, 13, (ph, pw))
        return Plane(np.clip(ramp + noise, 0, peak).astype(np.int16))

    return Frame(plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2))


FRAME_CONFIGS = [
    dict(),
    dict(block_size=4, entropy_coder="cabac", scan="mode"),
    dict(block_size=16, entropy_coder="hevc-slice", qp=30),
    dict(mode_set="all", decision="sad", intra_smoothing=True),
    dict(decision="satd", dequant_rescale=True, qp=35),
    dict(bit_depth=10, qp=28),
]


@lru_cache(maxsize=None)
def _frame_codec(i, h, w):
    cfg = EncoderConfig(**FRAME_CONFIGS[i])
    frame = make_frame(h, w, 20 + i, cfg.bit_depth)
    jr, jb = jax_wf.encode_frame_closed_loop(frame, cfg)
    tr, tb = torch_wf.encode_frame_closed_loop(port_frame(frame),
                                               port_cfg(cfg), device="cpu")
    return jr, jb, tr, tb


@pytest.mark.parametrize("shape", [(32, 48), (36, 52)])
@pytest.mark.parametrize("i", range(len(FRAME_CONFIGS)),
                         ids=[_grid_id(c) or "default" for c in FRAME_CONFIGS])
def test_encode_frame_bytes_match_jax(i, shape):
    jr, jb, tr, tb = _frame_codec(i, *shape)
    assert tb == jb
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(tr, p).data, getattr(jr, p).data), p
        assert getattr(tr, p).data.dtype == getattr(jr, p).data.dtype


@pytest.mark.parametrize("shape", [(32, 48), (36, 52)])
@pytest.mark.parametrize("i", range(len(FRAME_CONFIGS)),
                         ids=[_grid_id(c) or "default" for c in FRAME_CONFIGS])
def test_decode_frame_matches_jax(i, shape):
    jr, jb, tr, tb = _frame_codec(i, *shape)
    want = jax_wf.decode_frame(jb)
    got = torch_wf.decode_frame(tb, device="cpu")
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(got, p).data, getattr(want, p).data), p
        assert np.array_equal(getattr(got, p).data, getattr(tr, p).data), p


def test_mode_search_frame_round_trip():
    """The CLI's --mode-search config, decoded back pixel for pixel."""
    cfg = port_config.EncoderConfig(mode_set="all", decision="satd")
    frame = port_frame(make_frame(40, 64, 31))
    recon, bits = torch_wf.encode_frame_closed_loop(frame, cfg, device="cpu")
    dec = torch_wf.decode_frame(bits, device="cpu")
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(dec, p).data, getattr(recon, p).data)


def test_frame_entry_points_ask_for_the_card(monkeypatch):
    """Without device="cpu" the frame codec runs on the card, and fails
    where there is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, bits = _frame_codec(0, 32, 48)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_wf.encode_frame_closed_loop(port_frame(make_frame(16, 16, 1)),
                                          port_config.EncoderConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        torch_wf.decode_frame(bits)


@pytest.mark.parametrize("cut", ["params", "plane"])
def test_decode_frame_rejects_corrupt_streams(cut):
    _, _, _, bits = _frame_codec(0, 32, 48)
    from nanohevc_tpu_torch.runtime.bitstream import _split_nals
    from nanohevc_tpu_torch.runtime.entropy import NAL_SLICE, wrap_nal

    nals = _split_nals(bits)
    if cut == "params":
        keep = [wrap_nal(t, p) for t, p in nals if t == NAL_SLICE]
    else:
        keep = [wrap_nal(t, p) for t, p in nals][:-1]
    with pytest.raises(CorruptBitstreamError):
        torch_wf.decode_frame(b"".join(keep), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(decision="rd", deblock=True), dict(rdoq=True, sao=True),
    dict(deblock=True), dict(sao=True), dict(sao_ctb=True),
])
def test_unported_closed_loop_options_raise(kw):
    """The closed-loop options once refused here: the plane encode's
    outputs (the per-frame SAO parameters included) equal JAX's; the
    frame's stream decodes to its recon, and with deblocking alone its
    bytes equal JAX's (tests/test_torch_loop_filters.py holds every
    filter's frames to JAX)."""
    frame = make_frame(16, 16, 1)
    tr, tb = torch_wf.encode_frame_closed_loop(
        port_frame(frame), port_config.EncoderConfig(**kw), device="cpu")
    decoded = torch_wf.decode_frame(tb, device="cpu")
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(decoded, p).data, getattr(tr, p).data)
    if not (kw.get("sao") or kw.get("sao_ctb")):
        jr, jb = jax_wf.encode_frame_closed_loop(frame, EncoderConfig(**kw))
        assert tb == jb
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(tr, p).data, getattr(jr, p).data)
    planes = seeded_planes(1, 16, 16, 1)
    j, t = _both(planes, 22, n=8, **kw)
    _assert_planes_equal(j, t)
    for k in ("sao", "sao_ctb"):
        assert (k in t) == (k in j) == kw.get(k, False)
        for a, b in zip(t.get(k, ()), j.get(k, ())):
            assert np.array_equal(a.numpy(), np.asarray(b)), k


@pytest.mark.parametrize("kw,kernel", [
    (dict(), True),
    (dict(mode_set="all", decision="satd"), True),
    (dict(mode_set="all", decision="satd", use_dst=True, n=4), True),
    (dict(mode_set="all", decision="satd", intra_smoothing=True), True),
    (dict(decision="sad"), True),
    (dict(mode_set="all", decision="energy"), True),
    (dict(allow_fast=False), True),
    (dict(rdoq=True), True),
    (dict(mode_set="dc"), True),
    (dict(decision="rd"), False),
])
@pytest.mark.parametrize("batch", [1, 2])
def test_routing(monkeypatch, kw, kernel, batch):
    """The wavefront kernel takes every closed-loop configuration but
    decision="rd" (every mode set and per-block decision, smoothing,
    RDOQ, allow_fast=False) at every batch size, one call a batch."""
    calls = []
    real = torch_wf.wavefront_encode_planes

    def spy(planes, qp, n, **k):
        calls.append((tuple(planes.shape), n))
        return real(planes, qp, n, **k)

    monkeypatch.setattr(torch_wf, "wavefront_encode_planes", spy)
    kw = dict(kw)
    n = kw.pop("n", 8)
    planes = torch.from_numpy(seeded_planes(batch, 20, 28, 3))
    torch_wf.encode_planes_closed_loop(planes, 22, n=n, **kw)
    padded = (batch, -(-20 // n) * n, -(-28 // n) * n)
    assert calls == ([(padded, n)] if kernel else [])


def test_allow_fast_refuses_uncovered_configs():
    planes = torch.from_numpy(seeded_planes(1, 16, 16, 4))
    for kw in (dict(decision="sad"), dict(intra_smoothing=True)):
        with pytest.raises(ValueError):
            torch_wf.encode_planes_closed_loop(planes, 22, n=8,
                                               allow_fast=True, **kw)


@pytest.mark.parametrize("args", [
    dict(n=5),
    dict(mode_set="all", decision="rd"),
    dict(use_dst=True),
])
def test_supported_matches_the_tpu_kernels(args):
    """wavefront_supported is the union of the TPU kernels' checks; the
    wrapper refuses what the kernel does not cover (wavefront_covers:
    every mode set and per-block decision, DST at N=4 only)."""
    from nanohevc_tpu.kernels.wavefront_mode_slab import (
        wavefront_mode_kernel_supported,
    )
    from nanohevc_tpu.kernels.wavefront_slab import wavefront_kernel_supported

    for n in (4, 5, 8, 16, 32):
        for ms, dec in (("dc_planar", "energy"), ("all", "satd"),
                        ("all", "sad"), ("dc_planar", "satd")):
            for dst in (False, True):
                want = (wavefront_kernel_supported(n, ms, dec, dst)
                        or wavefront_mode_kernel_supported(n, ms, dec, dst))
                assert kwf.wavefront_supported(n, ms, dec, dst) == want
                assert kwf.wavefront_covers(n, ms, dec, dst) == (
                    n != 5 and (n == 4 or not dst))
    planes = torch.from_numpy(seeded_planes(1, 16, 16, 2))
    kw = dict(dict(n=8, mode_set="dc_planar", decision="energy"), **args)
    n = kw.pop("n")
    with pytest.raises(ValueError):
        kwf.wavefront_encode_planes(planes, 22, n, **kw)


@pytest.mark.parametrize("bad", ["dtype", "dims", "aligned", "contiguous"])
def test_wrapper_validates_input(bad):
    planes = torch.from_numpy(seeded_planes(1, 16, 24, 2))
    if bad == "dtype":
        planes = planes.to(torch.int64)
    elif bad == "dims":
        planes = planes[0]
    elif bad == "aligned":
        planes = planes[:, :, :20].contiguous()
    else:
        planes = planes.transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        kwf.wavefront_encode_planes(planes, 22, 8)


# The kernel's bodies and switches: (mode_set, decision[, keywords]).
WRAPPER_CASES = [
    ("dc_planar", "energy"),
    ("all", "satd"),
    ("dc", "energy"),
    ("planar", "sad", dict(intra_smoothing=True)),
    ("dc_planar", "sad", dict(intra_smoothing=True, rdoq=True)),
    ("dc_planar", "satd", dict(rdoq=True, scan="mode")),
    ("all", "energy", dict(intra_smoothing=True)),
    ("all", "sad", dict(rdoq=True, scan="horizontal", rd_lambda_scale=4.0)),
    ("all", "satd", dict(intra_smoothing=True, rdoq=True, scan="vertical",
                         dequant_rescale=True)),
]


def _wrapper_kw(body):
    return dict(dict(mode_set=body[0], decision=body[1]),
                **(body[2] if len(body) > 2 else {}))


@pytest.mark.parametrize("body", WRAPPER_CASES)
def test_wrapper_on_cpu_is_the_plain_version(body):
    planes = torch.from_numpy(seeded_planes(2, 24, 32, 6))
    kw = _wrapper_kw(body)
    before = kwf.wavefront_encode_planes.launches
    got = kwf.wavefront_encode_planes(planes, 25, 8, **kw)
    want = kwf.wavefront_encode_planes_reference(planes, 25, 8, **kw)
    assert kwf.wavefront_encode_planes.launches == before
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("body", WRAPPER_CASES)
def test_cuda_kernel_matches_plain(body):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine chip_smoke.py "
                    "phases 3c and 3g run this check")
    planes = torch.from_numpy(seeded_planes(2, 40, 72, 8)).cuda()
    kw = _wrapper_kw(body)
    got = kwf.wavefront_encode_planes(planes, 25, 8, **kw)
    want = kwf.wavefront_encode_planes_reference(planes, 25, 8, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 2])
@pytest.mark.parametrize("body", [c for c in WRAPPER_CASES
                                  if len(c) > 2 and c[2].get("rdoq")])
def test_cuda_kernel_on_capped_grids_matches_plain(body, cap):
    """The row schedule on a grid of one or two thread blocks, which
    code the rows one after another and wait only on lower tickets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine chip_smoke.py "
                    "phase 3g runs this check")
    planes = torch.from_numpy(seeded_planes(3, 40, 72, 9)).cuda()
    kw = _wrapper_kw(body)
    grids = kwf.wavefront_encode_planes.grids
    got = kwf.wavefront_encode_planes(planes, 25, 8, _max_grid=cap, **kw)
    want = kwf.wavefront_encode_planes_reference(planes, 25, 8, **kw)
    assert kwf.wavefront_encode_planes.grids == grids + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_wrapper_work_buffer():
    """The ticket, then one edge line of Wp words under each block row of
    each plane but the last; none for a plane of one block row."""
    assert kwf.work_ints(3, 40, 72, 8) == 1 + 3 * 4 * 72
    assert kwf.work_ints(2, 8, 72, 8) == 1
    assert kwf.work_ints(1, 1088, 1920, 32) == 1 + 33 * 1920


def textured_planes(b, h, w, seed):
    """Seeded 8-bit planes of ramps at several angles plus noise, so that
    the angular modes that read the extensions win some blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(b):
        a, c = rng.integers(-6, 7, 2)
        wave = 40 * np.sin(xx / rng.uniform(3, 9) + yy / rng.uniform(3, 9))
        noise = rng.integers(-6, 7, (h, w))
        out.append(np.clip(128 + a * yy + c * xx + wave + noise, 0, 255))
    return np.stack(out).astype(np.int32)


def raster_encode(planes, qp, n, mode_set, decision, use_dst, rule=True):
    """The closed loop coded block by block in raster order, the order
    in which the kernel's rows advance.  With `rule`, the extensions
    T[N+1..2N] and L[N+1..2N] are overwritten as the availability rule
    says (0, or T[N] / L[N] replicated at the last block-column / row)
    instead of read from the reconstruction."""
    from nanohevc_tpu_torch.ops.mode_decision import decide_modes

    b, hp, wp = planes.shape
    nby, nbx = hp // n, wp // n
    recon = torch.zeros_like(planes)
    levels = torch.empty((b, nby * nbx, n, n), dtype=torch.int32)
    modes = torch.empty((b, nby * nbx), dtype=torch.int32)
    for by in range(nby):
        for bx in range(nbx):
            refs = ops.extract_refs_at(recon, torch.tensor([by]),
                                       torch.tensor([bx]), n, 128)[:, 0]
            if rule and by > 0:
                refs[:, n + 1:2 * n + 1] = (refs[:, n:n + 1]
                                            if bx == nbx - 1 else 0)
            if rule and bx > 0:
                left_n = refs[:, 3 * n + 1:3 * n + 2]
                refs[:, 3 * n + 2:] = left_n if by == nby - 1 else 0
            blk = planes[:, by * n:(by + 1) * n, bx * n:(bx + 1) * n]
            pred, mode = decide_modes(blk, refs, n, mode_set, decision)
            lev = ops.quantize(ops.forward_transform(blk - pred, use_dst), qp, n)
            res = ops.inverse_transform(ops.dequantize(lev, qp, n), use_dst)
            recon[:, by * n:(by + 1) * n, bx * n:(bx + 1) * n] = (
                (pred + res).clamp(0, 255))
            levels[:, by * nbx + bx] = lev
            modes[:, by * nbx + bx] = mode.reshape(b)
    return {"recon": recon, "levels": levels, "modes": modes}


RASTER_SIZES = [(4, True), (4, False), (8, False), (16, False), (32, False)]


@pytest.mark.parametrize("blocks", [(3, 5), (1, 6), (6, 1)],
                         ids=["3x5", "one-row", "one-column"])
@pytest.mark.parametrize("n,use_dst", RASTER_SIZES,
                         ids=[f"n={n}{'-dst' if d else ''}"
                              for n, d in RASTER_SIZES])
@pytest.mark.parametrize("body", list(kwf.BODIES))
def test_raster_order_with_the_rule_matches_reference(body, n, use_dst,
                                                      blocks):
    """What the kernel's row schedule relies on: coding the blocks in
    raster order, with the extensions written by the availability rule
    and never read, gives the diagonal walk's result exactly."""
    planes = torch.from_numpy(
        textured_planes(2, blocks[0] * n, blocks[1] * n, 3 * n + blocks[0]))
    mode_set, decision = body
    got = raster_encode(planes, 27, n, mode_set, decision, use_dst)
    want = kwf.wavefront_encode_planes_reference(
        planes, 27, n, mode_set=mode_set, decision=decision, use_dst=use_dst)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("n", [4, 8, 16])
def test_raster_order_reading_the_extensions_differs(n):
    """The raster-order check has teeth: the search body reads the
    extensions, so reading the top-right block's reconstruction (already
    coded in raster order) instead of writing the rule changes the
    result on a textured plane."""
    planes = torch.from_numpy(textured_planes(2, 6 * n, 8 * n, n))
    got = raster_encode(planes, 27, n, "all", "satd", False, rule=False)
    want = kwf.wavefront_encode_planes_reference(planes, 27, n,
                                                 mode_set="all",
                                                 decision="satd")
    assert not torch.equal(got["modes"], want["modes"])
