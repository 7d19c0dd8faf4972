"""The blocks-API fused pipeline (K5): the port's plain version vs the
JAX Pallas kernel.

`fused_encode_blocks_reference` and `fused_encode_planes_reference`
(CPU) are held bit-exactly against `nanohevc_tpu.kernels`'
`fused_encode_blocks` / `fused_encode_planes` run through the Pallas
interpreter (`interpret=True`), as tests/test_pallas.py runs them.  The
JAX kernel's lane chunk is at least 128 blocks, so every case whose
block count is no multiple of 128 goes through its pad-and-trim path.
The CUDA kernel is held against the same plain version by the
`cuda`-marked test, which needs a card and skips without one.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu.kernels import fused_encode_blocks as jax_blocks
from nanohevc_tpu.kernels import fused_encode_planes as jax_planes
from nanohevc_tpu_torch.kernels import fused_pipeline
from nanohevc_tpu_torch.kernels.fused_pipeline import (
    fused_encode_blocks,
    fused_encode_blocks_reference,
    fused_encode_planes,
    fused_encode_planes_reference,
)


def _check_planes(planes, qp, n, bit_depth=8):
    want = jax_planes(jnp.asarray(planes), qp, n, bit_depth=bit_depth,
                      interpret=True)
    got = fused_encode_planes(torch.from_numpy(planes), qp, n,
                              bit_depth=bit_depth)
    for k in ("recon", "levels"):
        arr = got[k].numpy()
        assert arr.dtype == np.int32, k
        assert arr.shape == np.asarray(want[k]).shape, k
        assert np.array_equal(arr, np.asarray(want[k])), k
    return got


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("qp", [0, 22, 37, 51])
def test_planes_match_jax_kernel(n, qp):
    rng = np.random.default_rng(10 * n + qp)
    planes = rng.integers(0, 256, (1, 2 * n, 3 * n)).astype(np.int32)
    _check_planes(planes, qp, n)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_planes_10bit_fill_128(n):
    """At 10 bits the references outside the plane still read 128 (the
    default fill of extract_refs), unlike the slab kernel's 512."""
    rng = np.random.default_rng(70 + n)
    planes = rng.integers(0, 1024, (1, 2 * n, 2 * n)).astype(np.int32)
    got = _check_planes(planes, 30, n, bit_depth=10)
    # the slab kernel's fill of 512 gives another top-left block
    from nanohevc_tpu_torch.kernels.slab_pipeline import slab_encode_plane_reference
    k1 = slab_encode_plane_reference(torch.from_numpy(planes[0]), 30, n,
                                     bit_depth=10)
    assert not torch.equal(got["recon"][0, :n, :n], k1["recon"][:n, :n])


@pytest.mark.parametrize("n", [4, 8])
def test_ragged_plane_recon_fill_0(n):
    """45x200: rows below the last full block-row come out as 0 (the
    slab kernel passes them through)."""
    rng = np.random.default_rng(n)
    planes = rng.integers(1, 256, (1, 45, 200)).astype(np.int32)
    got = _check_planes(planes, 22, n)
    rows = (45 // n) * n
    assert not got["recon"][0, rows:].any()


def test_ragged_columns_recon_fill_0():
    rng = np.random.default_rng(5)
    planes = rng.integers(1, 256, (1, 32, 44)).astype(np.int32)
    got = _check_planes(planes, 27, 8)
    assert not got["recon"][0, :, 40:].any()


def test_batch_folds_into_blocks():
    """F = 2 frames in one call equal each frame on its own."""
    rng = np.random.default_rng(11)
    planes = rng.integers(0, 256, (2, 24, 40)).astype(np.int32)
    got = _check_planes(planes, 22, 8)
    for f in range(2):
        one = fused_encode_planes_reference(torch.from_numpy(planes[f:f + 1]),
                                            22, 8)
        for k in ("recon", "levels"):
            assert torch.equal(got[k][f], one[k][0])


@pytest.mark.parametrize("n,qp", [(4, 51), (8, 0), (16, 22), (32, 37)])
def test_blocks_with_given_refs(n, qp):
    """Arbitrary blocks and references (not from one plane); 15 blocks,
    no multiple of the JAX kernel's chunk."""
    rng = np.random.default_rng(200 + n)
    blocks = rng.integers(0, 256, (15, n, n)).astype(np.int32)
    refs = rng.integers(0, 256, (15, 4 * n + 2)).astype(np.int32)
    want_r, want_l = jax_blocks(jnp.asarray(blocks), jnp.asarray(refs), qp,
                                interpret=True)
    got_r, got_l = fused_encode_blocks(torch.from_numpy(blocks),
                                       torch.from_numpy(refs), qp)
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("qp", [-5, 60])
def test_qp_clamped(qp):
    rng = np.random.default_rng(3)
    blocks = torch.from_numpy(rng.integers(0, 256, (6, 8, 8)).astype(np.int32))
    refs = torch.from_numpy(rng.integers(0, 256, (6, 34)).astype(np.int32))
    got = fused_encode_blocks(blocks, refs, qp)
    want = fused_encode_blocks(blocks, refs, 0 if qp < 0 else 51)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_dct_at_4x4_not_dst():
    """K5 transforms 4x4 blocks with the DCT: its levels equal the slab
    path's at use_dst=False and differ from those at use_dst=True."""
    from nanohevc_tpu_torch.kernels.slab_pipeline import slab_encode_plane_reference

    rng = np.random.default_rng(8)
    plane = rng.integers(0, 256, (16, 16)).astype(np.int32)
    got = fused_encode_planes_reference(torch.from_numpy(plane[None]), 22, 4)
    for dst, same in ((False, True), (True, False)):
        k1 = slab_encode_plane_reference(torch.from_numpy(plane), 22, 4,
                                         use_dst=dst)
        # K1's fill is 1 << (bd - 1) = 128 at 8 bits: the same references
        assert torch.equal(got["levels"][0], k1["levels"].reshape(16, 16)) == same


class TestValidation:
    def test_block_size(self):
        with pytest.raises(ValueError):
            fused_encode_blocks(torch.zeros((2, 6, 6), dtype=torch.int32),
                                torch.zeros((2, 26), dtype=torch.int32), 22)

    def test_refs_shape(self):
        with pytest.raises(ValueError):
            fused_encode_blocks(torch.zeros((2, 8, 8), dtype=torch.int32),
                                torch.zeros((2, 33), dtype=torch.int32), 22)

    def test_float_refused(self):
        with pytest.raises(TypeError):
            fused_encode_blocks(torch.zeros((2, 8, 8)),
                                torch.zeros((2, 34), dtype=torch.int32), 22)

    def test_other_device_raises(self):
        with pytest.raises(ValueError):
            fused_encode_blocks(
                torch.zeros((2, 8, 8), dtype=torch.int32, device="meta"),
                torch.zeros((2, 34), dtype=torch.int32, device="meta"), 22)

    def test_planes_rank(self):
        with pytest.raises(ValueError):
            fused_encode_planes(torch.zeros((16, 16), dtype=torch.int32), 22, 8)


def test_cpu_tensor_never_builds(monkeypatch):
    """CPU planes run the plain version: no build, no launch count."""
    def refuse():
        raise AssertionError("CPU input must not reach the CUDA build")

    monkeypatch.setattr(fused_pipeline, "cuda_kernels", refuse)
    before = fused_encode_blocks.launches
    rng = np.random.default_rng(9)
    planes = torch.from_numpy(rng.integers(0, 256, (2, 24, 32)).astype(np.int32))
    out = fused_encode_planes(planes, 22, 8)
    want = fused_encode_planes_reference(planes, 22, 8)
    for k in want:
        assert torch.equal(out[k], want[k])
    assert fused_encode_blocks.launches == before


def _blocks_view_at(values: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous view of `values` `offset` int32s into a fresh buffer."""
    buf = torch.zeros(values.numel() + 4, dtype=torch.int32,
                      device=values.device)
    view = buf[offset:offset + values.numel()].view(values.shape)
    view.copy_(values)
    return view


def test_misaligned_cpu_blocks_run_plain_without_copy():
    rng = np.random.default_rng(13)
    blocks = torch.from_numpy(rng.integers(0, 256, (5, 8, 8)).astype(np.int32))
    refs = torch.from_numpy(rng.integers(0, 256, (5, 34)).astype(np.int32))
    before = fused_encode_blocks.copies
    got = fused_encode_blocks(_blocks_view_at(blocks, 3), refs, 22)
    want = fused_encode_blocks_reference(blocks, refs, 22)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_encode_blocks.copies == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine run "
                    "python -m pytest -m cuda tests/test_torch_*.py")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_cuda_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    for bit_depth in (8, 10):
        planes = torch.from_numpy(
            rng.integers(0, 1 << bit_depth, (2, 45, 200 // n * n)).astype(np.int32)
        ).to(cuda_device)
        for qp in (0, 22, 37, 51):
            before = fused_encode_blocks.launches
            got = fused_encode_planes(planes, qp, n, bit_depth=bit_depth)
            want = fused_encode_planes_reference(planes, qp, n,
                                                 bit_depth=bit_depth)
            torch.cuda.synchronize()
            assert fused_encode_blocks.launches == before + 1
            for k in want:
                assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_cuda_misaligned_blocks_are_copied(cuda_device, n):
    """Blocks 4 bytes past a 16-byte boundary give the aligned blocks'
    outputs through one launch on a counted copy."""
    rng = np.random.default_rng(50 + n)
    blocks = torch.from_numpy(
        rng.integers(0, 256, (37, n, n)).astype(np.int32)).to(cuda_device)
    refs = torch.from_numpy(
        rng.integers(0, 256, (37, 4 * n + 2)).astype(np.int32)).to(cuda_device)
    view = _blocks_view_at(blocks, 1)
    copies = fused_encode_blocks.copies
    got = fused_encode_blocks(view, refs, 22)
    want = fused_encode_blocks_reference(blocks, refs, 22)
    torch.cuda.synchronize()
    assert fused_encode_blocks.copies == copies + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
