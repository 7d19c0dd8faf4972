"""The wavefront kernel's work count against values worked by hand, and
the three metrics of the search cell on stub contexts: its roofline
share by kernel name (the RD kernel's time left out), the wrapper's span
and its block counter, none where there is nothing to read."""

import sys
import types

import pytest

from conftest import BENCH
from benchlib import peaks, program, spec
from benchlib.trace import Trace

wf = spec.load_module("roofline", "wavefront", BENCH)


def read(name, ctx):
    return spec.load_module("metrics", name, BENCH).read(ctx)


def test_plane_work_at_16x16():
    # 256 pixels, 4 blocks of 8x8: the tail 8*8 + 18, the search 35
    # modes of 2*8 + 10 and 9 for planar and DC.
    ops, nbytes = wf.plane_work(8, 16, 16, "all", False, False)
    assert ops == (82 + 35 * 26 + 9) * 256 == 256256
    assert nbytes == 12 * 256 + 4 * 4
    smooth, _ = wf.plane_work(8, 16, 16, "all", False, True)
    rdoq, _ = wf.plane_work(8, 16, 16, "all", True, False)
    assert smooth - ops == 4 * 33 * 4
    assert rdoq - ops == 24 * 256
    assert wf.plane_work(4, 16, 16, "all", False, True) == wf.plane_work(
        4, 16, 16, "all", False, False)
    pair, _ = wf.plane_work(8, 16, 16, "dc_planar", False, False)
    assert pair == (82 + 16) * 256
    # A plane padded up to blocks: 12x20 at N=8 codes 16x24.
    assert wf.plane_work(8, 12, 20, "all", False, False) == wf.plane_work(
        8, 16, 24, "all", False, False)


def test_bound_matches_the_smoke_checks_figure():
    # chip_smoke's kernel_bound(search=True): 31.0 us for a 1080p luma
    # plane at N=8, bound by operations.
    t, by = peaks.least_seconds(*wf.plane_work(8, 1080, 1920, "all", False,
                                               False))
    assert by == "operations" and t == pytest.approx(30.98e-6, abs=0.01e-6)


def test_frame_sums_its_three_planes():
    config = {"encoder": {"block_size": 8, "mode_set": "all",
                          "chroma_mode_set": None, "rdoq": False,
                          "intra_smoothing": True}}
    t, by = wf.least_seconds(config, {"height": 1080, "width": 1920})
    luma = (82 + 919) * 1920 * 1080 + 4 * 33 * 240 * 135
    chroma = (50 + 35 * 18 + 9) * 960 * 540
    assert t == pytest.approx((luma + 2 * chroma) / 67e12)
    assert by == "operations"


class Ctx:
    def __init__(self, trace=None):
        self.trace = trace

    def roofline_s(self, kernel):
        return {"wavefront": 2e-9}[kernel]


def two_frames():
    spans = [("frame", 0, 100), ("frame", 100, 200)]
    device = [("void wavefront_kernel<8, 2, 2, false>(int const*, ...)", 10,
               30, "kernel"),
              ("void wavefront_rd_kernel<8, 1, false, 16>(RdArgs)", 30, 90,
               "kernel"),
              ("void wavefront_kernel<4, 2, 2, false>(int const*, ...)", 110,
               130, "kernel")]
    return Trace(spans, device)


def test_roofline_share_reads_the_wavefront_kernel_alone():
    got = read("roofline_pct.wavefront", Ctx(two_frames()))
    assert got == pytest.approx(100 * 2e-9 * 2 / 40e-9)
    assert read("roofline_pct.wavefront", Ctx()) is None
    rd_only = Trace([("frame", 0, 100)],
                    [("void wavefront_rd_kernel<8, 1, false, 16>(RdArgs)", 0,
                      50, "kernel")])
    assert read("roofline_pct.wavefront", Ctx(rd_only)) is None


@pytest.fixture
def registry(monkeypatch):
    def install(spans=None, counts=None):
        mod = types.ModuleType(program.TRACING)
        if spans is not None:
            mod.SPANS = types.SimpleNamespace(totals=spans)
        if counts is not None:
            mod.COUNTS = counts
        monkeypatch.setitem(sys.modules, program.TRACING, mod)
    return install


def test_span_and_counter_per_frame(registry):
    registry({"wavefront.launch": 0.003}, {"wavefront.blocks": 2 * 97200})
    ctx = Ctx(two_frames())
    assert read("wavefront_launch_ms_per_frame", ctx) == pytest.approx(1.5)
    assert read("wavefront_blocks_per_frame", ctx) == 97200
    assert read("wavefront_launch_ms_per_frame", Ctx()) is None
    assert read("wavefront_blocks_per_frame", Ctx()) is None


def test_none_against_a_program_without_them(registry):
    for spans, counts in ((None, None), ({}, {}),
                          ({"frame.fetch": 1.0}, {"frame.bytes_up": 8})):
        registry(spans, counts)
        assert read("wavefront_launch_ms_per_frame", Ctx(two_frames())) is None
        assert read("wavefront_blocks_per_frame", Ctx(two_frames())) is None
