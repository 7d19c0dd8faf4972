"""The mode-search kernel's plain PyTorch version vs the JAX package.

`mode_search_encode_plane_reference` (CPU) is held bit-exactly against
the JAX XLA path `encode_plane_full(mode_set="all", decision="satd")`,
the referee the JAX package's own kernel tests use: the JAX Pallas
kernels K2a/K2b cost 30-200 s each through the CPU interpreter, so the
test that runs them is marked slow.  The CUDA kernel is held against
the same plain version by the `cuda`-marked test, which needs a card
and skips without one.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nanohevc_tpu import ops as jops
from nanohevc_tpu.models.all_intra import encode_plane_full as jax_full
from nanohevc_tpu_torch.kernels import mode_search
from nanohevc_tpu_torch.kernels.mode_search import (
    mode_search_encode_plane,
    mode_search_encode_plane_reference,
    mode_search_supported,
)
from nanohevc_tpu_torch.models.all_intra import encode_plane_fast_modes


def _jax(plane, qp, n, **kw):
    """JAX XLA outputs: recon, raster levels, modes, packed levels, nnz."""
    out = jax_full(jnp.asarray(plane), jnp.int32(qp), n=n, mode_set="all",
                   decision="satd", **kw)
    return (np.asarray(out["recon"]), np.asarray(jops.scan_unpack(out["levels"])),
            np.asarray(out["modes"]), np.asarray(out["levels"]),
            np.asarray(out["nnz"]))


def _check(plane, qp, n, **kw):
    recon, levels, modes, packed, nnz = _jax(plane, qp, n, **kw)
    got = mode_search_encode_plane_reference(torch.from_numpy(plane), qp, n, **kw)
    for name, want in (("recon", recon), ("levels", levels), ("modes", modes)):
        arr = got[name].numpy()
        assert arr.dtype == np.int32 and arr.shape == want.shape, name
        assert np.array_equal(arr, want), name
    fast = encode_plane_fast_modes(torch.from_numpy(plane), qp, n=n, **kw)
    for name, want in (("recon", recon), ("levels", packed), ("modes", modes),
                       ("nnz", nnz)):
        assert np.array_equal(fast[name].numpy(), want), name
    return got


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("qp", [0, 22, 51])
def test_reference_matches_jax(n, qp):
    rng = np.random.default_rng(1000 + n * 100 + qp)
    h, w = 2 * n + n // 2, 3 * n               # partial trailing rows
    plane = rng.integers(0, 256, (h, w)).astype(np.int32)
    _check(plane, qp, n)


@pytest.mark.parametrize("shape", [(12, 16), (20, 24), (16, 32)])
def test_reference_dst_4x4(shape):
    rng = np.random.default_rng(2000 + sum(shape))
    plane = rng.integers(0, 256, shape).astype(np.int32)
    _check(plane, 27, 4, use_dst=True)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_reference_10bit(n):
    rng = np.random.default_rng(3000 + n)
    plane = rng.integers(0, 1024, (2 * n + 3, 3 * n)).astype(np.int32)
    _check(plane, 30, n, bit_depth=10, use_dst=(n == 4))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_reference_dequant_rescale(n):
    rng = np.random.default_rng(4000 + n)
    plane = rng.integers(0, 256, (2 * n, 3 * n)).astype(np.int32)
    _check(plane, 4, n, dequant_rescale=True)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_partial_height_reads_true_trailing_rows(n):
    """Left references below the last block-row read the real trailing
    source rows (extract_refs clamps to the plane's last row, not the
    last block-row).  On a ramp along the anti-diagonals mode 2 predicts
    from those rows exactly; a wrong clamp changes the modes."""
    rows, cols = np.mgrid[0:2 * n + 5, 0:3 * n]
    plane = ((rows + cols) * 3).astype(np.int32)
    got = _check(plane, 24, n)
    clamped = plane.copy()
    clamped[2 * n:, :] = plane[2 * n - 1]              # wrong clamp
    other = mode_search_encode_plane_reference(torch.from_numpy(clamped), 24, n)
    assert not torch.equal(got["modes"], other["modes"])


def test_directional_content_picks_angular():
    base = np.add.outer(np.arange(24) * 9, np.arange(40) * 5) % 256
    got = _check(base.astype(np.int32), 20, 8)
    assert (got["modes"] >= 2).any()


def test_flat_plane_picks_planar():
    plane = np.full((16, 32), 128, np.int32)
    got = _check(plane, 22, 8)
    assert got["modes"].eq(0).all()


def test_supported():
    assert mode_search_supported(8, 1920) and mode_search_supported(4, 960)
    assert not mode_search_supported(16, 72)
    assert not mode_search_supported(6, 24)


class TestValidation:
    @pytest.mark.parametrize("plane,n,kw,exc", [
        (torch.zeros((16, 17), dtype=torch.int32), 8, {}, ValueError),
        (torch.zeros((24, 24), dtype=torch.int32), 6, {}, ValueError),
        (torch.zeros((16, 16), dtype=torch.int32), 8, {"use_dst": True}, ValueError),
        (torch.zeros((16, 16), dtype=torch.int16), 8, {}, TypeError),
        (torch.zeros((16, 32), dtype=torch.int32).T, 8, {}, ValueError),
        (torch.zeros((2, 16, 16), dtype=torch.int32), 8, {}, ValueError),
        (torch.zeros((16, 16), dtype=torch.int32, device="meta"), 8, {}, ValueError),
    ], ids=["width", "block_size", "dst", "dtype", "contiguous", "rank", "device"])
    def test_refused(self, plane, n, kw, exc):
        with pytest.raises(exc):
            mode_search_encode_plane(plane, 22, n, **kw)


def test_cpu_tensor_never_builds(monkeypatch):
    """A CPU plane runs the plain version: no build, no launch count."""
    def refuse():
        raise AssertionError("CPU input must not reach the CUDA build")

    monkeypatch.setattr(mode_search, "cuda_kernels", refuse)
    before = mode_search_encode_plane.launches
    rng = np.random.default_rng(9)
    plane = torch.from_numpy(rng.integers(0, 256, (24, 32)).astype(np.int32))
    out = mode_search_encode_plane(plane, 22, 8)
    want = mode_search_encode_plane_reference(plane, 22, 8)
    for k in want:
        assert torch.equal(out[k], want[k])
    assert mode_search_encode_plane.launches == before


def test_constant_table_layout():
    """Transforms, then the 33 angles, then the 33 inverse angles."""
    from nanohevc_tpu.tables import INTRA_PRED_ANGLE, INV_ANGLE

    table = mode_search.angle_table()
    assert table.dtype == np.int32 and table.shape == (66,)
    assert table[:33].tolist() == list(INTRA_PRED_ANGLE)
    for a, inv in zip(INTRA_PRED_ANGLE, table[33:]):
        assert inv == (INV_ANGLE[a] if a < 0 else 0)


@pytest.mark.slow
@pytest.mark.parametrize("n,use_dst", [(8, False), (4, True)])
def test_reference_matches_pallas_kernels(n, use_dst):
    """The plain version == K2a (mode_search_slab) and K2b
    (mode_search_grouped) run through the Pallas interpreter."""
    from nanohevc_tpu.kernels.mode_search_grouped import (
        mode_search_encode_plane_grouped,
    )
    from nanohevc_tpu.kernels.mode_search_slab import (
        mode_search_encode_plane as slab_search,
    )

    rng = np.random.default_rng(6000 + n)
    plane = rng.integers(0, 256, (2 * n + 3, 5 * n)).astype(np.int32)
    got = mode_search_encode_plane_reference(torch.from_numpy(plane), 26, n,
                                             use_dst=use_dst)
    outs = [slab_search(jnp.asarray(plane), 26, n, interpret=True,
                        use_dst=use_dst),
            mode_search_encode_plane_grouped(jnp.asarray(plane), 26, n, g=2,
                                             interpret=True, use_dst=use_dst)]
    for out in outs:
        assert np.array_equal(np.asarray(out["recon"]), got["recon"].numpy())
        assert np.array_equal(np.asarray(jops.tile_plane(out["levels_slab"], n)),
                              got["levels"].numpy())
        assert np.array_equal(np.asarray(out["modes_slab"])[::n, ::n].reshape(-1),
                              got["modes"].numpy())


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
            before = mode_search_encode_plane.launches
            got = mode_search_encode_plane(plane, 22, n, **kw)
            want = mode_search_encode_plane_reference(plane, 22, n, **kw)
            torch.cuda.synchronize()
            assert mode_search_encode_plane.launches == before + 1
            for k in want:
                assert torch.equal(got[k], want[k]), k
