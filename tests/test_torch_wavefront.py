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
    dict(decision="rd"), dict(rdoq=True), dict(deblock=True), dict(sao=True),
    dict(sao_ctb=True),
])
def test_unported_closed_loop_options_raise(kw):
    cfg = port_config.EncoderConfig(**kw)
    with pytest.raises(NotImplementedError):
        torch_wf.encode_frame_closed_loop(port_frame(make_frame(16, 16, 1)),
                                          cfg, device="cpu")
    planes = torch.from_numpy(seeded_planes(1, 16, 16, 1))
    with pytest.raises(NotImplementedError):
        torch_wf.encode_planes_closed_loop(planes, 22, n=8, **kw)


@pytest.mark.parametrize("kw,kernel", [
    (dict(), True),
    (dict(mode_set="all", decision="satd"), True),
    (dict(mode_set="all", decision="satd", use_dst=True, n=4), True),
    (dict(mode_set="all", decision="satd", intra_smoothing=True), False),
    (dict(decision="sad"), False),
    (dict(mode_set="all", decision="energy"), False),
    (dict(allow_fast=False), False),
])
@pytest.mark.parametrize("batch", [1, 2])
def test_routing(monkeypatch, kw, kernel, batch):
    """The wavefront kernel takes DC/planar by energy and the SATD
    search at every batch size, and nothing else."""
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
    dict(mode_set="all", decision="sad"),
    dict(use_dst=True),
])
def test_supported_matches_the_tpu_kernels(args):
    """wavefront_supported is the union of the TPU kernels' checks."""
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


@pytest.mark.parametrize("body", [("dc_planar", "energy"), ("all", "satd")])
def test_wrapper_on_cpu_is_the_plain_version(body):
    planes = torch.from_numpy(seeded_planes(2, 24, 32, 6))
    kw = dict(mode_set=body[0], decision=body[1])
    before = kwf.wavefront_encode_planes.launches
    got = kwf.wavefront_encode_planes(planes, 25, 8, **kw)
    want = kwf.wavefront_encode_planes_reference(planes, 25, 8, **kw)
    assert kwf.wavefront_encode_planes.launches == before
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("body", [("dc_planar", "energy"), ("all", "satd")])
def test_cuda_kernel_matches_plain(body):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine chip_smoke.py "
                    "phase 3c runs this check")
    planes = torch.from_numpy(seeded_planes(2, 40, 72, 8)).cuda()
    kw = dict(mode_set=body[0], decision=body[1])
    got = kwf.wavefront_encode_planes(planes, 25, 8, **kw)
    want = kwf.wavefront_encode_planes_reference(planes, 25, 8, **kw)
    for k in want:
        assert torch.equal(got[k], want[k]), k
