"""The reader of the program's "frame.waits" counter
(`card_waits_per_frame`): none without a trace, none against a program
that lacks the counter (a parent tree), per frame from a filled one."""

import json
import sys
import types

import pytest

from conftest import BENCH, ROOT
from benchlib import program, spec
from benchlib.trace import Trace

NAME = "card_waits_per_frame"


def read(ctx):
    return spec.load_module("metrics", NAME, BENCH).read(ctx)


class Ctx:
    def __init__(self, trace=None):
        self.trace = trace


def four_frames():
    return Trace([("frame", 100 * i, 100 * i + 90) for i in range(4)], [])


@pytest.fixture
def counts(monkeypatch):
    """Installs a stand-in for the program's tracing module with these
    COUNTS; None leaves the registry out, as a program without it."""
    def install(values):
        mod = types.ModuleType(program.TRACING)
        if values is not None:
            mod.COUNTS = values
        monkeypatch.setitem(sys.modules, program.TRACING, mod)
    return install


def test_none_without_a_trace(counts):
    counts({"frame.waits": 4})
    assert read(Ctx()) is None


@pytest.mark.parametrize("values", [None, {}, {"frame.bytes_up": 8}])
def test_none_against_a_program_without_the_counter(counts, values):
    counts(values)
    assert read(Ctx(four_frames())) is None


@pytest.mark.parametrize("waits,want", [(4, 1.0), (8, 2.0), (12, 3.0)])
def test_waits_per_frame(counts, waits, want):
    counts({"frame.waits": waits, "frame.bytes_up": 1})
    assert read(Ctx(four_frames())) == want


def test_in_the_benchmark_for_every_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert (m["source"], m["unit"], m["better"], m["layer"], m["moves"]) == (
        "program_counter", "waits", "lower", "frame encoder", "encode_fps")
    assert m["workloads"] == [w["name"] for w in bench["workloads"]]
