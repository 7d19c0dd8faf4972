"""The readers of the program's own spans and counters
(`nanohevc_tpu_torch.utils.tracing`): none without a trace, none
against a program that lacks the registry, per-frame values from a
filled one."""

import sys
import types

import pytest

from conftest import BENCH
from benchlib import program, spec
from benchlib.trace import Trace

SPANS = {
    "residual_coding_ms_per_frame": "entropy.residual",
    "scan_unpack_ms_per_frame": "entropy.scan",
    "mode_syntax_ms_per_frame": "entropy.modes",
    "sao_syntax_ms_per_frame": "entropy.sao",
    "upload_ms_per_frame": "frame.upload",
    "fetch_ms_per_frame": "frame.fetch",
    "convert_ms_per_frame": "frame.convert",
}
COUNTS = {
    "h2d_bytes_per_frame": "frame.bytes_up",
    "d2h_bytes_per_frame": "frame.bytes_down",
}
READERS = sorted(SPANS) + sorted(COUNTS)


def read(name, ctx):
    return spec.load_module("metrics", name, BENCH).read(ctx)


class Ctx:
    def __init__(self, trace=None):
        self.trace = trace


def four_frames():
    return Trace([("frame", 100 * i, 100 * i + 90) for i in range(4)], [])


def tracing_module(spans=None, counts=None):
    """A stand-in for the program's tracing module; None leaves the
    registry out, as a program without it."""
    mod = types.ModuleType(program.TRACING)
    if spans is not None:
        mod.SPANS = types.SimpleNamespace(totals=spans)
    if counts is not None:
        mod.COUNTS = counts
    return mod


@pytest.fixture
def registry(monkeypatch):
    def install(mod):
        monkeypatch.setitem(sys.modules, program.TRACING, mod)
    return install


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace(name, registry):
    registry(tracing_module({k: 1.0 for k in SPANS.values()},
                            {k: 8 for k in COUNTS.values()}))
    assert read(name, Ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_none_against_a_program_without_the_registry(name, registry):
    registry(tracing_module())
    assert read(name, Ctx(four_frames())) is None
    registry(tracing_module({}, {}))       # the registry, but no such name
    assert read(name, Ctx(four_frames())) is None


@pytest.mark.parametrize("name", READERS)
def test_per_frame_values_from_a_filled_registry(name, registry):
    spans = {k: 0.01 * (i + 1) for i, k in enumerate(sorted(SPANS.values()))}
    counts = {"frame.bytes_up": 4 * 12_441_600,
              "frame.bytes_down": 4 * 25_290_720}
    registry(tracing_module(spans, counts))
    got = read(name, Ctx(four_frames()))
    if name in SPANS:
        assert got == pytest.approx(spans[SPANS[name]] / 4 * 1e3)
    else:
        assert got == counts[COUNTS[name]] / 4


def test_every_reader_is_in_the_benchmark():
    import json

    from conftest import ROOT

    per_layer = {m["name"]: m for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["source"] == ("program_span" if name in SPANS
                               else "program_counter")
        assert m["unit"] == ("ms" if name in SPANS else "bytes")
