"""The port's multi-device encoding (`nanohevc_tpu_torch.parallel`) vs the
JAX package's (`nanohevc_tpu.parallel`).

JAX runs on its 8 virtual CPU devices (tests/conftest.py); the port on
a mesh of 8 "cpu" entries of the same (frame, space) shape.  Both take
the same seeded planes.  Recon, levels, modes, nnz, the SAO maps and
sequence bytes must be equal.  PSNR is a float32 reduction whose last
place JAX itself does not keep from one program to another (its eager
and its jitted psnr differ in the last place on about half of all
frames), so per-frame psnr and mean_psnr agree within rtol 1e-6.

Where the JAX package would run a Pallas kernel through the slow CPU
interpreter (the sharded 35-mode search, the closed loop's search
body), its side takes the XLA formulation of the same function, which
its own tests hold bit-exact to those kernels: `make_batch_encoder`
with honor_runtime_qp=True (its sharded XLA route), and the closed
loop with allow_fast=False.  The sharded slab kernel runs as JAX's own
tests run it, in interpret mode.
"""

from functools import lru_cache

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import nanohevc_tpu.models.sequence as jax_seq
import nanohevc_tpu.models.wavefront as jax_wf
from nanohevc_tpu.config import EncoderConfig as JaxConfig
from nanohevc_tpu.parallel import (
    encode_batch_sharded as jax_encode_batch_sharded,
    make_batch_encoder as jax_batch_encoder,
    make_closed_loop_encoder as jax_closed_loop_encoder,
    make_mesh as jax_make_mesh,
)
from nanohevc_tpu.parallel.spatial import (
    make_sharded_fast_encoder as jax_sharded_fast_encoder,
    sharded_fast_supported as jax_sharded_fast_supported,
)
from nanohevc_tpu_torch.config import EncoderConfig
from nanohevc_tpu_torch.models import sequence as seq
from nanohevc_tpu_torch.parallel import sharding
from nanohevc_tpu_torch.parallel import (
    encode_batch_sharded,
    make_batch_encoder,
    make_closed_loop_encoder,
    make_mesh,
)
from nanohevc_tpu_torch.parallel.spatial import (
    make_sharded_fast_encoder,
    sharded_fast_supported,
)

SEED = 21
WIDTH = 64
SEARCH = dict(mode_set="all", decision="satd")
RTOL = 1e-6


@lru_cache(maxsize=None)
def meshes(space: int):
    """(JAX mesh over its 8 devices, the port's mesh over 8 "cpu")."""
    return jax_make_mesh(space=space), make_mesh(["cpu"] * 8, space=space)


@lru_cache(maxsize=None)
def frames(space: int, n_frames: int | None = None, height: int | None = None,
           width: int = WIDTH) -> np.ndarray:
    """The seeded batch of one mesh shape: 8 // space frames of
    32 * space + 8 rows (a bottom pad at every space > 1)."""
    rng = np.random.default_rng(SEED + space)
    shape = (n_frames or 8 // space, height or 32 * space + 8, width)
    return rng.integers(0, 256, shape).astype(np.int32)


def assert_same(jax_out: dict, port_out: dict):
    """The same keys; psnr and mean_psnr within RTOL, every other output
    (recon, levels, modes, nnz, the SAO parameters) bit for bit."""
    assert set(port_out) == set(jax_out)
    for k, want in jax_out.items():
        got = port_out[k]
        if k in ("psnr", "mean_psnr"):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, err_msg=k)
            continue
        pairs = zip(want, got, strict=True) if isinstance(want, tuple) \
            else [(want, got)]
        for a, b in pairs:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=k)


class TestMesh:
    @pytest.mark.parametrize("space", [1, 2, 4])
    def test_mesh_shape(self, space):
        jm, tm = meshes(space)
        assert tm.devices.shape == jm.devices.shape == (8 // space, space)
        assert tm.axis_names == jm.axis_names == ("frame", "space")
        assert tm.shape == dict(jm.shape)
        assert all(d == torch.device("cpu") for d in tm.devices.flat)

    def test_invalid_space_raises(self):
        with pytest.raises(ValueError) as jax_err:
            jax_make_mesh(space=3)
        with pytest.raises(ValueError) as port_err:
            make_mesh(["cpu"] * 8, space=3)
        assert str(port_err.value) == str(jax_err.value)

    def test_default_mesh_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh(["cuda", "cuda"])


@pytest.mark.parametrize("cfg, height, is_luma", [
    (dict(), 32, True), (dict(), 40, True), (dict(), 44, True),
    (SEARCH, 32, True), (SEARCH, 40, True),
    (dict(intra_smoothing=True), 32, True),
    (dict(SEARCH, intra_smoothing=True), 32, True),
    (dict(decision="sad"), 32, True), (dict(rdoq=True), 32, True),
    (dict(), 36, False), (dict(), 38, False), (SEARCH, 20, False),
], ids=lambda v: str(v))
@pytest.mark.parametrize("space", [1, 2])
def test_sharded_fast_supported(space, cfg, height, is_luma):
    jm, tm = meshes(space)
    want = jax_sharded_fast_supported(JaxConfig(block_size=8, **cfg), jm,
                                      height, WIDTH, is_luma)
    got = sharded_fast_supported(EncoderConfig(block_size=8, **cfg), tm,
                                 height, WIDTH, is_luma)
    assert got == want


@lru_cache(maxsize=None)
def jax_spatial(variant: str, space: int, n: int) -> dict:
    """JAX's sharded encoder on `frames(space)`: the slab kernel in
    interpret mode, the search through its sharded XLA route."""
    jm, _ = meshes(space)
    planes = jnp.asarray(frames(space))
    if variant == "slab":
        out = jax_sharded_fast_encoder(JaxConfig(block_size=n, qp=25), jm)(planes)
    else:
        out = jax_batch_encoder(JaxConfig(block_size=n, qp=25, **SEARCH), jm,
                                honor_runtime_qp=True)(planes, jnp.int32(25))
    return {k: np.asarray(out[k]) for k in ("recon", "levels", "modes")}


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("variant", ["slab", "mode_search"])
def test_spatial_encoder(variant, space, n):
    """Row shards with halos, bottom-padded height: == JAX's shards."""
    cfg = dict(SEARCH) if variant == "mode_search" else {}
    _, tm = meshes(space)
    fn = make_sharded_fast_encoder(EncoderConfig(block_size=n, qp=25, **cfg),
                                   tm, variant)
    got = fn(torch.from_numpy(frames(space)))
    want = jax_spatial(variant, space, n)
    assert got["recon"].shape == frames(space).shape
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("route, cfg", [
    ("kernel", dict()), ("kernel", dict(scan="mode")),
    ("plain", dict(rdoq=True)), ("plain", dict(rdo_cbf=True)),
], ids=["slab", "slab-mode-scan", "rdoq", "rdo_cbf"])
def test_batch_encoder_under_mesh(route, cfg, monkeypatch):
    built = []
    real = sharding.make_sharded_fast_encoder

    def spy(config, mesh, variant, is_luma):
        built.append(variant)
        return real(config, mesh, variant, is_luma)

    monkeypatch.setattr(sharding, "make_sharded_fast_encoder", spy)
    jm, tm = meshes(2)
    planes = frames(2)
    want = jax_batch_encoder(JaxConfig(block_size=8, qp=22, **cfg), jm)(
        jnp.asarray(planes), jnp.int32(22))
    got = make_batch_encoder(EncoderConfig(block_size=8, qp=22, **cfg), tm)(
        torch.from_numpy(planes), 22)
    assert_same(want, got)
    assert built == (["slab"] if route == "kernel" else [])


def test_batch_encoder_runtime_qp_under_mesh():
    """honor_runtime_qp: JAX leaves its kernels for XLA; the port's
    kernels take the runtime QP and give the same outputs."""
    jm, tm = meshes(4)
    planes = frames(4)
    want = jax_batch_encoder(JaxConfig(block_size=8, qp=22), jm,
                             honor_runtime_qp=True)(jnp.asarray(planes),
                                                    jnp.int32(34))
    got = make_batch_encoder(EncoderConfig(block_size=8, qp=22), tm,
                             honor_runtime_qp=True)(torch.from_numpy(planes), 34)
    assert_same(want, got)


def test_encode_batch_sharded():
    jm, tm = meshes(1)
    planes = frames(1)
    cfg = dict(block_size=4, qp=30)
    want = jax_encode_batch_sharded(planes, 30, JaxConfig(**cfg), jm)
    assert_same(want, encode_batch_sharded(planes, 30, EncoderConfig(**cfg), tm))


def test_smoothing_under_mesh():
    """The sharded plain route keeps intra_smoothing (JAX's regression
    test at tests/test_sharding.py)."""
    jm, tm = meshes(1)
    planes = frames(1)
    cfg = dict(block_size=8, qp=22, intra_smoothing=True, **SEARCH)
    want = jax_batch_encoder(JaxConfig(**cfg), jm)(jnp.asarray(planes),
                                                   jnp.int32(22))
    assert_same(want, make_batch_encoder(EncoderConfig(**cfg), tm)(
        torch.from_numpy(planes), 22))


def test_mean_psnr_reduction():
    jm, tm = meshes(1)
    planes = frames(1, 8, 32, 32)
    cfg = dict(block_size=4, qp=30)
    want = jax_encode_batch_sharded(planes, 30, JaxConfig(**cfg), jm)
    got = encode_batch_sharded(planes, 30, EncoderConfig(**cfg), tm)
    per_frame = got["psnr"].numpy()
    assert np.isfinite(per_frame).all()
    assert abs(float(got["mean_psnr"]) - per_frame.mean()) < 1e-3
    assert_same(want, got)


@pytest.fixture
def jax_xla_closed_loop(monkeypatch):
    """Pin JAX's closed-loop search to its XLA formulation."""
    real = jax_wf.encode_planes_closed_loop

    def xla_scan(*a, **kw):
        kw["allow_fast"] = False if kw.get("mode_set") == "all" else None
        return real(*a, **kw)

    monkeypatch.setattr(jax_wf, "encode_planes_closed_loop", xla_scan)
    jax_seq._closed_loop_jit.cache_clear()
    yield
    jax_seq._closed_loop_jit.cache_clear()


@pytest.mark.usefixtures("jax_xla_closed_loop")
@pytest.mark.parametrize("cfg", [
    dict(), SEARCH, dict(deblock=True, sao_ctb=True, sao_tile=16),
    dict(deblock=True, sao=True),
], ids=["default", "search", "deblock+sao_ctb", "deblock+sao"])
def test_closed_loop_under_mesh(cfg):
    """Frame shards of the wavefront encoder, filters and SAO maps
    included, == JAX's shard_map over 'frame'."""
    jm, tm = meshes(2)
    planes = frames(2, 8, 40, 48)
    want = jax_closed_loop_encoder(JaxConfig(block_size=8, qp=24, **cfg), jm)(
        jnp.asarray(planes), jnp.int32(24))
    got = make_closed_loop_encoder(EncoderConfig(block_size=8, qp=24, **cfg),
                                   tm)(torch.from_numpy(planes), 24)
    assert_same(want, got)
    # each frame shard's launch equals the mesh-less encode of its frames
    alone = make_closed_loop_encoder(EncoderConfig(block_size=8, qp=24, **cfg))(
        torch.from_numpy(planes), 24)
    for k in ("recon", "levels", "modes"):
        assert torch.equal(got[k], alone[k]), k


class TestRefusals:
    """Where JAX's sharding refuses a batch, the port raises ValueError;
    where JAX runs, the port gives its outputs."""

    def test_batch_not_a_multiple_of_frame_axis(self):
        jm, tm = meshes(2)
        planes = frames(2, 3)
        for cfg in (dict(), dict(rdoq=True)):
            with pytest.raises(ValueError):
                jax_batch_encoder(JaxConfig(**cfg), jm)(jnp.asarray(planes),
                                                        jnp.int32(22))
            with pytest.raises(ValueError, match="'frame' axis"):
                make_batch_encoder(EncoderConfig(**cfg), tm)(
                    torch.from_numpy(planes), 22)
        with pytest.raises(ValueError):
            jax_closed_loop_encoder(JaxConfig(), jm)(jnp.asarray(planes),
                                                     jnp.int32(22))
        with pytest.raises(ValueError, match="'frame' axis"):
            make_closed_loop_encoder(EncoderConfig(), tm)(
                torch.from_numpy(planes), 22)

    def test_height_not_a_multiple_of_space_axis(self):
        jm, tm = meshes(2)
        planes = frames(2, 4, 33)
        with pytest.raises(ValueError):
            jax_batch_encoder(JaxConfig(), jm)(jnp.asarray(planes),
                                               jnp.int32(22))
        with pytest.raises(ValueError, match="'space' axis"):
            make_batch_encoder(EncoderConfig(), tm)(torch.from_numpy(planes), 22)
        # the closed loop does not split rows: JAX runs it, and so does
        # the port
        want = jax_closed_loop_encoder(JaxConfig(), jm)(jnp.asarray(planes),
                                                        jnp.int32(22))
        got = make_closed_loop_encoder(EncoderConfig(), tm)(
            torch.from_numpy(planes), 22)
        assert_same(want, got)

    @pytest.mark.parametrize("cfg, height, width, fast", [
        (dict(), 44, WIDTH, "encode_plane_fast"),
        (dict(block_size=16), 1080, 32, "encode_plane_fast"),
        (dict(SEARCH, block_size=16), 56, WIDTH, "encode_plane_fast_modes"),
        (dict(rdoq=True), 44, WIDTH, None),
    ], ids=["slab-n8", "slab-n16-1080", "search-n16", "rdoq"])
    def test_ragged_height_takes_the_frame_sharded_route(
            self, cfg, height, width, fast, monkeypatch):
        """A height that is no whole number of block-rows: no sharded
        kernel; the frame shards, where JAX runs its XLA pipeline and the
        port each plane's kernel wherever it covers the width, on the
        runtime QP (not config.qp) as XLA does."""
        calls = {"encode_plane_fast": 0, "encode_plane_fast_modes": 0}
        for name in calls:
            real = getattr(sharding, name)

            def spy(*a, _real=real, _name=name, **kw):
                calls[_name] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(sharding, name, spy)
        jm, tm = meshes(2)
        planes = frames(2, 4, height, width)
        config = dict(cfg, qp=22)
        want = jax_batch_encoder(JaxConfig(**config), jm)(jnp.asarray(planes),
                                                          jnp.int32(30))
        got = make_batch_encoder(EncoderConfig(**config), tm)(
            torch.from_numpy(planes), 30)
        assert_same(want, got)
        assert calls == {k: 4 if k == fast else 0 for k in calls}


def write_sequence(path, width, height, n_frames):
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 256, n_frames * width * height * 3 // 2,
                        dtype=np.uint8)
    path.write_bytes((data // 4 + 96).astype(np.uint8).tobytes())
    return str(path)


@pytest.mark.usefixtures("jax_xla_closed_loop")
@pytest.mark.parametrize("closed_loop, cfg", [
    (False, dict()), (True, dict()),
    (True, dict(deblock=True, sao_ctb=True, sao_tile=16)),
], ids=["open", "closed", "closed-deblock+sao_ctb"])
def test_sequence_under_mesh(tmp_path, closed_loop, cfg):
    """encode_sequence under a (4, 2) mesh, 6 frames at batch 4 (a
    ragged tail): JAX's bytes and sidecar."""
    src = write_sequence(tmp_path / "s.yuv", 32, 32, 6)
    jm, tm = meshes(2)
    runs = []
    for tag, mod, config, mesh, extra in (
            ("jax", jax_seq, JaxConfig(**cfg), jm, {}),
            ("port", seq, EncoderConfig(**cfg), tm, {"device": "cpu"})):
        bits = tmp_path / f"{tag}.bin"
        res = mod.encode_sequence(src, 32, 32, 6, config, str(bits), batch=4,
                                  mesh=mesh, closed_loop=closed_loop, **extra)
        runs.append((res, bits.read_bytes(),
                     (tmp_path / f"{tag}.bin.progress").read_text()))
    (jr, jbits, jside), (tr, tbits, tside) = runs
    assert tbits == jbits and tside == jside
    assert (tr.frames, tr.resumed_from, tr.bytes_written) == (
        jr.frames, jr.resumed_from, jr.bytes_written)
    assert tr.mean_psnr_y == pytest.approx(jr.mean_psnr_y, rel=RTOL)
    if closed_loop:
        assert seq.decode_sequence(str(tmp_path / "port.bin"),
                                   str(tmp_path / "d.yuv"), device="cpu") == 6


def test_sequence_closed_loop_batch_not_a_multiple(tmp_path):
    src = write_sequence(tmp_path / "s.yuv", 32, 32, 2)
    jm, tm = meshes(2)
    with pytest.raises(ValueError) as jax_err:
        jax_seq.encode_sequence(src, 32, 32, 2, JaxConfig(),
                                str(tmp_path / "j.bin"), batch=3, mesh=jm,
                                closed_loop=True)
    with pytest.raises(ValueError) as port_err:
        seq.encode_sequence(src, 32, 32, 2, EncoderConfig(),
                            str(tmp_path / "t.bin"), batch=3, mesh=tm,
                            closed_loop=True, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert not (tmp_path / "t.bin").exists()


def test_sequence_device_must_be_the_mesh_first_device(tmp_path, monkeypatch):
    src = write_sequence(tmp_path / "s.yuv", 32, 32, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="first device"):
        seq.encode_sequence(src, 32, 32, 2, EncoderConfig(),
                            str(tmp_path / "t.bin"), batch=4,
                            mesh=make_mesh(["cuda:0"] * 2), device="cpu")
    assert not (tmp_path / "t.bin").exists()
