"""Nothing of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the port; a run without a card, or in a
directory holding only the benchmark, prints no result."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "nanohevc_tpu"}


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = top_level_imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "plainref").rglob("*.py")):
        names = top_level_imports(path)
        assert "nanohevc_tpu_torch" not in names, path
        assert names <= {"__future__", "dataclasses", "functools", "math",
                         "struct", "typing", "numpy", "torch", "plainref"}, (
            path, names)


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run

    monkeypatch.setitem(sys.modules, "nanohevc_tpu_torch_like", object())
    assert "nanohevc_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nanohevc_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"nanohevc_tpu.ops", "jaxlib"} <= set(run.forbidden_modules())


ARGS = ["--workload", "ctc_ai_n8.frame.qp37", "--seed", "1", "--seconds",
        "1", "--trace", "0"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_jax_loaded_by_the_check_gives_no_result(monkeypatch, capsys):
    """The look for JAX is made again once the reference has run: a
    check that loads it prints no result."""
    import types

    from conftest import SMALL
    from plainref import encoder
    import run

    orig = encoder.encode_frames

    def loads_jax(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(*args, **kwargs)
    monkeypatch.setattr(encoder, "encode_frames", loads_jax)
    with pytest.raises(SystemExit) as stop:
        run.main(["--workload", "ctc_ai_n8.frame.qp37", "--seed", "5",
                  "--seconds", "0.2"], device="cpu", overrides=SMALL)
    assert stop.value.code != 0
    out, err = capsys.readouterr()
    assert out.strip() == "" and "jax" in err
