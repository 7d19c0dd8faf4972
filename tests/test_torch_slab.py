"""The slab kernel's plain PyTorch version vs the JAX Pallas kernel.

`slab_encode_plane_reference` (CPU) is held bit-exactly against
`nanohevc_tpu.kernels.slab_pipeline.slab_encode_plane` run through the
Pallas interpreter, as the JAX package's own tests run it here.  The
CUDA kernel is held against the same plain version by the `cuda`-marked
test, which needs a card and skips without one.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu.kernels.slab_pipeline import slab_encode_plane as jax_slab
from nanohevc_tpu.ops import tile_plane as jax_tile
from nanohevc_tpu_torch.kernels import build, slab_pipeline
from nanohevc_tpu_torch.kernels.slab_pipeline import (
    aligned16,
    slab_encode_plane,
    slab_encode_plane_reference,
)


def _jax_outputs(plane, qp, n, **kw):
    """JAX kernel outputs in the port's layout (recon, levels, modes)."""
    out = jax_slab(jnp.asarray(plane), qp, n, interpret=True,
                   with_modes=True, **kw)
    return (
        np.asarray(out["recon"]),
        np.asarray(jax_tile(out["levels_slab"], n)),
        np.asarray(out["modes_slab"][::n, ::n]).reshape(-1),
    )


def _check(plane, qp, n, **kw):
    recon, levels, modes = _jax_outputs(plane, qp, n, **kw)
    got = slab_encode_plane_reference(torch.from_numpy(plane), qp, n, **kw)
    for name, want in (("recon", recon), ("levels", levels), ("modes", modes)):
        arr = got[name].numpy()
        assert arr.dtype == np.int32, name
        assert np.array_equal(arr, want), name


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("qp", [0, 22, 37, 51])
def test_reference_matches_jax_kernel(n, qp):
    rng = np.random.default_rng(n * 100 + qp)
    h, w = 2 * n + n // 2, 4 * n               # partial trailing rows
    plane = rng.integers(0, 256, (h, w)).astype(np.int32)
    _check(plane, qp, n)


@pytest.mark.parametrize("shape", [(12, 16), (20, 24), (16, 32)])
def test_reference_dst_4x4(shape):
    rng = np.random.default_rng(sum(shape))
    plane = rng.integers(0, 256, shape).astype(np.int32)
    _check(plane, 27, 4, use_dst=True)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_reference_10bit(n):
    rng = np.random.default_rng(41 + n)
    plane = rng.integers(0, 1024, (2 * n + 3, 3 * n)).astype(np.int32)
    _check(plane, 30, n, bit_depth=10, use_dst=(n == 4))


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("qp", [4, 28])
def test_reference_dequant_rescale(n, qp):
    """Spec size rescale, including the left-shift branch (dq_shift <= 0)."""
    rng = np.random.default_rng(51 + n + qp)
    plane = rng.integers(0, 256, (2 * n, 3 * n)).astype(np.int32)
    _check(plane, qp, n, dequant_rescale=True)


def test_smooth_plane_ties_go_to_dc():
    """A flat plane gives equal energies: every block must pick DC."""
    plane = np.full((16, 32), 77, np.int32)
    _check(plane, 22, 8)
    got = slab_encode_plane_reference(torch.from_numpy(plane), 22, 8)
    assert got["modes"].eq(1).all()


class TestValidation:
    def test_width_not_multiple(self):
        with pytest.raises(ValueError):
            slab_encode_plane(torch.zeros((16, 17), dtype=torch.int32), 22, 8)

    def test_block_size(self):
        with pytest.raises(ValueError):
            slab_encode_plane(torch.zeros((24, 24), dtype=torch.int32), 22, 6)

    def test_dst_needs_4x4(self):
        with pytest.raises(ValueError):
            slab_encode_plane(torch.zeros((16, 16), dtype=torch.int32), 22, 8,
                              use_dst=True)

    def test_dtype(self):
        with pytest.raises(TypeError):
            slab_encode_plane(torch.zeros((16, 16), dtype=torch.int16), 22, 8)

    def test_contiguous(self):
        x = torch.zeros((16, 32), dtype=torch.int32).T
        with pytest.raises(ValueError):
            slab_encode_plane(x, 22, 8)

    def test_rank(self):
        with pytest.raises(ValueError):
            slab_encode_plane(torch.zeros((2, 16, 16), dtype=torch.int32), 22, 8)

    def test_other_device_raises(self):
        x = torch.zeros((16, 16), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            slab_encode_plane(x, 22, 8)


def test_cpu_tensor_never_builds(monkeypatch):
    """A CPU plane runs the plain version: no build, no launch count."""
    def refuse():
        raise AssertionError("CPU input must not reach the CUDA build")

    monkeypatch.setattr(slab_pipeline, "cuda_kernels", refuse)
    before = slab_encode_plane.launches
    rng = np.random.default_rng(9)
    plane = torch.from_numpy(rng.integers(0, 256, (24, 32)).astype(np.int32))
    out = slab_encode_plane(plane, 22, 8)
    want = slab_encode_plane_reference(plane, 22, 8)
    for k in want:
        assert torch.equal(out[k], want[k])
    assert slab_encode_plane.launches == before


def test_generated_table_header_holds_transform_table():
    """The row kernels compile the transform matrices in as immediates,
    from a header generated out of `transform_table()`."""
    text = build.generated_headers()["transform_table.h"]
    body = text.split("#define NHV_TRANSFORM_TABLE {", 1)[1].split("}", 1)[0]
    values = np.array([int(v) for v in body.split(",")], np.int32)
    assert np.array_equal(values, slab_pipeline.transform_table())


def test_source_hash_covers_generated_headers(monkeypatch):
    before = build.source_hash()
    monkeypatch.setattr(build, "generated_headers",
                        lambda: {"transform_table.h": "// another table\n"})
    assert build.source_hash() != before


def _view_at(values: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous view of `values` starting `offset` int32s into a
    fresh buffer (4 * offset bytes past its 16-byte-aligned start)."""
    buf = torch.zeros(values.numel() + 4, dtype=torch.int32,
                      device=values.device)
    view = buf[offset:offset + values.numel()].view(values.shape)
    view.copy_(values)
    return view


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_aligned16_copies_only_misaligned(offset):
    """The row kernels read int4 rows: a view 4, 8 or 12 bytes past a
    16-byte boundary is cloned (and counted), an aligned one is not."""
    values = torch.arange(64, dtype=torch.int32).view(8, 8)
    view = _view_at(values, offset)
    before = slab_encode_plane.copies
    out = aligned16(view, slab_encode_plane)
    misaligned = offset % 4 != 0
    assert (view.data_ptr() % 16 != 0) == misaligned
    assert out.data_ptr() % 16 == 0 and out.is_contiguous()
    assert torch.equal(out, values)
    assert (out is view) == (not misaligned)
    assert slab_encode_plane.copies == before + misaligned


def test_misaligned_cpu_plane_runs_plain_without_copy():
    """On the CPU the plain version takes any view: no copy is counted."""
    rng = np.random.default_rng(12)
    plane = torch.from_numpy(rng.integers(0, 256, (16, 24)).astype(np.int32))
    before = slab_encode_plane.copies
    got = slab_encode_plane(_view_at(plane, 1), 22, 8)
    want = slab_encode_plane_reference(plane, 22, 8)
    for k in want:
        assert torch.equal(got[k], want[k])
    assert slab_encode_plane.copies == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the GPU machine run "
                    "python -m pytest -m cuda tests/test_torch_*.py")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,use_dst", [(4, False), (4, True), (8, False),
                                       (16, False), (32, False)])
def test_cuda_kernel_matches_plain(cuda_device, n, use_dst):
    rng = np.random.default_rng(n)
    for bit_depth in (8, 10):
        for rescale in (False, True):
            plane = torch.from_numpy(
                rng.integers(0, 1 << bit_depth, (270, 480)).astype(np.int32)
            ).to(cuda_device)
            kw = dict(bit_depth=bit_depth, use_dst=use_dst,
                      dequant_rescale=rescale)
            before = slab_encode_plane.launches
            got = slab_encode_plane(plane, 22, n, **kw)
            want = slab_encode_plane_reference(plane, 22, n, **kw)
            torch.cuda.synchronize()
            assert slab_encode_plane.launches == before + 1
            for k in want:
                assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_cuda_misaligned_plane_is_copied(cuda_device, n):
    """A view 4 bytes past a 16-byte boundary gives the aligned plane's
    outputs through one launch on a counted copy."""
    rng = np.random.default_rng(40 + n)
    plane = torch.from_numpy(
        rng.integers(0, 256, (96, 160)).astype(np.int32)).to(cuda_device)
    view = _view_at(plane, 1)
    copies, launches = slab_encode_plane.copies, slab_encode_plane.launches
    got = slab_encode_plane(view, 22, n)
    want = slab_encode_plane(plane, 22, n)
    torch.cuda.synchronize()
    assert slab_encode_plane.copies == copies + 1
    assert slab_encode_plane.launches == launches + 2
    for k in want:
        assert torch.equal(got[k], want[k]), k
