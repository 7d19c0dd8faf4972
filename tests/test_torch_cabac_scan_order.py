"""The CABAC coder's scan-order entry (`hevc.encode_plane_cabac_scan`).

The frame encoder hands `assemble_bitstream` each plane's levels packed
in every block's spec 6.5.3 scan order.  On the `cabac` path the native
coder reads them in that order as they come: its payload is the raster
entry's (`encode_plane_cabac`) of the blocks unpacked to raster, the
raster entry's decoder gives that raster back, and `_np_unpack` is never
called.  While a profiler records, the blocks so read are counted as
"entropy.scan_order_blocks"; the `range` and `hevc-slice` paths count
nothing.
"""

import itertools

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import nanohevc_tpu.runtime.bitstream as j_bits
from nanohevc_tpu_torch.runtime import bitstream as t_bits
from nanohevc_tpu_torch.runtime import hevc
from nanohevc_tpu_torch.utils import tracing

NB = 60


def _packed(rng, n, density):
    """(NB, n*n) levels, first and last block all zero, a few levels
    large enough to escape to exp-Golomb."""
    lv = rng.integers(-4, 5, (NB, n * n)) * (rng.random((NB, n * n)) < density)
    lv[rng.random(lv.shape) < 0.01] *= 900
    lv[0] = lv[-1] = 0
    return lv.astype(np.int32)


@pytest.mark.parametrize("n,density", itertools.product(
    (4, 8, 16, 32), (0.0, 0.02, 0.3, 1.0)))
def test_scan_entry_equals_raster_entry(n, density):
    rng = np.random.default_rng([n, int(density * 100)])
    packed = _packed(rng, n, density)
    sels = [np.full(NB, s, np.int64) for s in (0, 1, 2)]
    sels.append(rng.integers(0, 3, NB))
    for sel, (c_idx, qp) in zip(sels, ((0, 22), (1, 37), (2, 30), (0, 51))):
        raster = t_bits._np_unpack(packed, sel, n)
        got = hevc.encode_plane_cabac_scan(packed, sel, c_idx=c_idx, qp=qp)
        want = hevc.encode_plane_cabac(raster, sel, c_idx=c_idx, qp=qp)
        assert got == want
        back = hevc.decode_plane_cabac(got, NB, n, sel, c_idx=c_idx, qp=qp)
        assert np.array_equal(back, raster)


def test_scan_entry_rejects_what_the_raster_entry_rejects():
    with pytest.raises(ValueError):
        hevc.encode_plane_cabac_scan(np.zeros((2, 36), np.int32), 0)
    with pytest.raises(ValueError):
        hevc.encode_plane_cabac_scan(np.zeros((2, 4, 4), np.int32), 0)
    with pytest.raises(ValueError):
        hevc.encode_plane_cabac_scan(np.zeros((2, 16), np.int32), [0, 3])
    with pytest.raises(ValueError):
        hevc.encode_plane_cabac_scan(np.zeros((2, 16), np.int32), [0, 1, 2])
    assert hevc.encode_plane_cabac_scan(
        np.zeros((0, 64), np.int32), 0) == hevc.encode_plane_cabac(
        np.zeros((0, 8, 8), np.int32), 0)


def _frame_planes(rng):
    """A 32x48 frame's slices under scan="mode": Y at 8, U/V at 4."""
    levels, modes = {}, {}
    for name, nb, n in (("Y", 24, 8), ("U", 24, 4), ("V", 24, 4)):
        lv = rng.integers(-3, 4, (nb, n * n)) * (rng.random((nb, n * n)) < 0.3)
        levels[name] = (lv.astype(np.int32), n)
        modes[name] = rng.integers(0, 35, nb).astype(np.int32)
    return levels, modes


def _refused(*args, **kwargs):
    raise AssertionError("_np_unpack called on the cabac path")


def test_cabac_path_never_unpacks_to_raster(monkeypatch):
    levels, modes = _frame_planes(np.random.default_rng(5))
    kw = dict(scan="mode", entropy_coder="cabac", deblock=True)
    want = j_bits.assemble_bitstream(48, 32, 32, levels, modes, **kw)
    monkeypatch.setattr(t_bits, "_np_unpack", _refused)
    assert t_bits.assemble_bitstream(48, 32, 32, levels, modes, **kw) == want


@pytest.mark.parametrize("coder", ["cabac", "range", "hevc-slice"])
def test_scan_order_blocks_counted_on_the_cabac_path_only(coder):
    levels, modes = _frame_planes(np.random.default_rng(6))
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            t_bits.assemble_bitstream(48, 32, 32, levels, modes, scan="mode",
                                      entropy_coder=coder)
        got = tracing.COUNTS.get("entropy.scan_order_blocks")
    finally:
        tracing.reset()
    if coder == "cabac":
        assert got == sum(lv.shape[0] for lv, _ in levels.values())
    else:
        assert got is None
