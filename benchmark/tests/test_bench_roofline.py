"""The frozen work counts against values worked by hand."""

import pytest

from conftest import BENCH
from benchlib import peaks, spec

rd = spec.load_module("roofline", "wavefront_rd", BENCH)
lf = spec.load_module("roofline", "loop_filter", BENCH)


def test_rd_plane_work_at_16x16():
    # 256 pixels, 4 blocks, 3 diagonals; 35 candidates at N=8.
    ops, nbytes = rd.plane_work(8, 16, 16, "all", False, False)
    assert ops == (35 * (64 + 18 + 40) + 64 + 18) * 256 + 2 * 3600 * 3
    assert nbytes == 12 * 256 + 4 * 4
    rdoq, _ = rd.plane_work(8, 16, 16, "all", True, False)
    smooth, _ = rd.plane_work(8, 16, 16, "all", False, True)
    assert rdoq - ops == 24 * 256
    assert smooth - ops == 4 * 33 * 4
    assert rd.plane_work(4, 16, 16, "all", False, True) == rd.plane_work(
        4, 16, 16, "all", False, False)
    dcp, _ = rd.plane_work(8, 16, 16, "dc_planar", False, False)
    assert dcp == (2 * 122 + 82) * 256 + 3600 * 3


def test_rd_bound_matches_the_smoke_checks_figure():
    # chip_smoke's rd_bound: 134.73 us for a 1080p luma plane, 35 modes, N=8.
    ops, nbytes = rd.plane_work(8, 1080, 1920, "all", False, False)
    t, by = peaks.least_seconds(ops, nbytes)
    assert by == "operations" and t == pytest.approx(134.73e-6, abs=0.01e-6)


def test_rd_frame_sums_its_three_planes():
    config = {"encoder": {"block_size": 8, "mode_set": "all", "rdoq": True,
                          "intra_smoothing": True}}
    t, by = rd.least_seconds(config, {"height": 64, "width": 132})
    want = sum(peaks.least_seconds(*w)[0] for w in (
        rd.plane_work(8, 64, 132, "all", True, True),
        rd.plane_work(4, 32, 66, "all", True, False),
        rd.plane_work(4, 32, 66, "all", True, False)))
    assert t == pytest.approx(want) and by == "operations"


def test_filter_work():
    assert lf.kernel_work("deblock_planes", 4096, 1) == (18 * 4096, 8 * 4096)
    assert lf.kernel_work("sao_estimate", 4096, 1) == (
        45 * 4096 + 600, 8 * 4096 + 4 * 102)
    assert lf.kernel_work("sao_apply", 4096, 1) == (12 * 4096, 8 * 4096 + 24)
    config = {"encoder": {"block_size": 8, "sao_tile": 64}}
    t, by = lf.least_seconds(config, {"height": 64, "width": 64})
    # Luma 64x64 (one tile), chroma 32x32 twice (one tile each): bytes bound.
    want = sum(peaks.least_seconds(*lf.kernel_work(k, px, 1))[0]
               for px in (4096, 1024, 1024) for k in lf.FILTER_OPS)
    assert t == pytest.approx(want) and by == "bytes"
