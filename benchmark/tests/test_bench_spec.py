"""The harness finds every piece of a cell by name from its files, and a
cell added as files and a BENCHMARK.json entry alone runs."""

import importlib.util
import json
import re
import shutil

import pytest

from conftest import BENCH, ROOT, SMALL
from benchlib import spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = spec.find_cell(name, ROOT, BENCH)
    assert cell.config["name"] == next(
        w["config"] for w in BENCHMARK["workloads"] if w["name"] == name)
    entry = spec.load_module("entries", cell.workload["entry"], BENCH)
    assert hasattr(entry, "Entry")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"], BENCH).read)
        if m["name"].startswith("roofline_pct."):
            kernel = m["name"].split(".", 1)[1]
            work = {**cell.config["frame"], **cell.workload}
            t, by = spec.load_module("roofline", kernel, BENCH).least_seconds(
                cell.config, work)
            assert t > 0 and by in ("bytes", "operations")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCHMARK[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCHMARK["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in BENCHMARK["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCHMARK["per_layer"]}
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e and m["layer"] in layers
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A throwaway cell: a new cell file and a BENCHMARK.json entry in a
    copy of the benchmark, no other file touched, run on the CPU."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ctc_ai_n8.frame.tiny", "config":
                               "ctc_ai_n8", "traffic": "frame.tiny",
                               "chips": 1, "why": "throwaway"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = {"entry": "frame", "traffic": "frame.tiny", "qp": 32, "noise": 4,
            **SMALL}
    (tmp_path / "benchmark" / "workloads" / "ctc_ai_n8.frame.tiny.json"
     ).write_text(json.dumps(cell))
    mod_spec = importlib.util.spec_from_file_location(
        "bench_tmp_run", tmp_path / "benchmark" / "run.py")
    run = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(run)
    out = run.main(["--workload", "ctc_ai_n8.frame.tiny", "--seed", "7",
                    "--seconds", "0.5"], device="cpu")
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"encode_fps", "setup_s"}
