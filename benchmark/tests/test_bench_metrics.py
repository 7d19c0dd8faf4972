"""Each metric's reader on a synthetic window and profiler table."""

import pytest

from conftest import BENCH
from benchlib import spec
from benchlib.trace import Trace
from benchlib.window import Window


def read(name, ctx):
    return spec.load_module("metrics", name, BENCH).read(ctx)


class Ctx:
    def __init__(self, trace=None, **kw):
        self.trace = trace
        self.window = Window(latencies_s=[0.1] * 19 + [0.3], failed=0,
                             start=10.0, end=12.5)
        self.setup_s = 7.5
        self.counters = {"wavefront_rd.wavefront_rd_encode_planes": 60,
                         "loop_filter.deblock_planes": 60}
        self.__dict__.update(kw)

    def roofline_s(self, kernel):
        return {"wavefront_rd": 3e-9, "loop_filter": 1e-9}[kernel]


def synthetic():
    # Two frames of 100 ns; host spans and device work in ns.
    spans = [("frame", 0, 100), ("entropy", 60, 90),
             ("frame", 100, 200), ("entropy", 150, 190)]
    device = [("Memcpy HtoD (Pageable -> Device)", 0, 10, "memcpy"),
              ("void wavefront_rd_kernel<8, 1, false, 16>(RdArgs)", 10, 40,
               "kernel"),
              ("void deblock_kernel<false, true>(...)", 40, 45, "kernel"),
              ("void wavefront_rd_kernel<4, 1, false, 0>(RdArgs)", 110, 150,
               "kernel"),
              ("outside the window", 300, 400, "kernel")]
    return Trace(spans, device)


def test_host_clock_readers():
    ctx = Ctx()
    assert read("encode_fps", ctx) == pytest.approx(20 / 2.5)
    assert read("frame_latency_p95_ms", ctx) == pytest.approx(110.0)
    assert read("setup_s", ctx) == 7.5
    assert read("launches_per_frame", ctx) == pytest.approx(120 / 20)


def test_trace_readers():
    t = synthetic()
    assert t.frames == 2 and t.window_s == pytest.approx(200e-9)
    assert t.busy_s == pytest.approx(85e-9)
    ctx = Ctx(trace=t)
    assert read("device_idle_pct", ctx) == pytest.approx(100 * 115 / 200)
    assert read("device_ms_per_frame.frame", ctx) == pytest.approx(85e-9 / 2 * 1e3)
    assert read("copy_ms_per_frame", ctx) == pytest.approx(10e-9 / 2 * 1e3)
    assert read("entropy_ms_per_frame", ctx) == pytest.approx(70e-9 / 2 * 1e3)
    assert read("roofline_pct.wavefront_rd", ctx) == pytest.approx(
        100 * 3e-9 * 2 / 70e-9)
    assert read("roofline_pct.loop_filter", ctx) == pytest.approx(
        100 * 1e-9 * 2 / 5e-9)


def test_breakdown():
    t = synthetic()
    ops = dict(t.top_ops())
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(10e-9)
    assert "outside the window" not in ops
    # Gaps 45-110 and 150-200 split by the innermost open span.
    assert dict(t.idle_gaps()) == pytest.approx(
        {"frame": 45e-9, "entropy": 70e-9})


def test_readers_leave_out_what_they_cannot_read():
    ctx = Ctx()
    for name in ("device_idle_pct", "entropy_ms_per_frame",
                 "device_ms_per_frame.frame", "copy_ms_per_frame",
                 "roofline_pct.wavefront_rd", "roofline_pct.loop_filter"):
        assert read(name, ctx) is None
    bare = Trace([("frame", 0, 100)], [])
    for name in ("entropy_ms_per_frame", "copy_ms_per_frame",
                 "roofline_pct.wavefront_rd", "roofline_pct.loop_filter",
                 "device_ms_per_frame.frame"):
        assert read(name, Ctx(trace=bare)) is None
    assert read("device_idle_pct", Ctx(trace=bare)) == 100.0
