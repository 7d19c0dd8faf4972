"""Everything of a run found by name from files.

`BENCHMARK.json` (at the root of the checkout) names the cells, the
configurations and the metrics; the benchmark's folder holds one file
per piece:

- a configuration: `configs/<config>.json`;
- a cell: `workloads/<cell>.json` (its entry, QP, content parameters,
  frame count);
- an entry: `entries/<entry>.py`;
- a metric's reader: `metrics/<metric>.py`;
- a kernel's work count: `roofline/<kernel>.py`.

A new cell, configuration, entry, metric or work count is a new file and
a new entry in `BENCHMARK.json`; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent        # the benchmark's folder


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    workload: dict        # workloads/<cell>.json
    end_to_end: tuple     # BENCHMARK.json metrics this cell reports
    per_layer: tuple


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path, folder: Path = HERE) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(folder / "configs" / f"{w['config']}.json"),
        workload=load_json(folder / "workloads" / f"{name}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def load_module(kind: str, name: str, folder: Path = HERE):
    """`<folder>/<kind>/<name>.py` as a module (names may hold dots)."""
    path = folder / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
