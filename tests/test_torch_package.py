"""The port imports no JAX.

The GPU machine has no JAX, so `nanohevc_tpu_torch` (and
`chip_smoke.py`) may import from `nanohevc_tpu` only the jax-free host
modules.  Checked twice: statically over the sources, and by running
the port in a process where importing jax raises.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "nanohevc_tpu_torch"
SHARED = {"config", "frame", "tables", "ref", "runtime"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            if node.module == "nanohevc_tpu":
                for alias in node.names:
                    yield f"nanohevc_tpu.{alias.name}"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    if top in ("jax", "jaxlib"):
        return True
    if top == "nanohevc_tpu":
        parts = module.split(".")
        return len(parts) > 1 and parts[1] not in SHARED
    return False


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


def test_scanner_catches_jax():
    assert _forbidden("jax.numpy")
    assert _forbidden("nanohevc_tpu.ops")
    assert _forbidden("nanohevc_tpu.models.all_intra")
    assert not _forbidden("nanohevc_tpu.runtime.bitstream")
    assert not _forbidden("torch")


JAX_BLOCKED = textwrap.dedent("""
    import sys

    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib"):
            del sys.modules[name]

    class NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked: " + name)
            return None

    sys.meta_path.insert(0, NoJax())

    import numpy as np
    from nanohevc_tpu.config import EncoderConfig
    from nanohevc_tpu_torch import create_test_frame, encode_frame_full
    from nanohevc_tpu_torch.cli import main

    recon, info = encode_frame_full(create_test_frame(32, 32),
                                    EncoderConfig(), device="cpu")
    assert recon.y.data.shape == (32, 32)
    assert info["planes"]["Y"]["levels"].shape == (16, 64)
    cfg = EncoderConfig(mode_set="all", decision="satd", intra_smoothing=True)
    recon, info = encode_frame_full(create_test_frame(32, 32), cfg, device="cpu")
    assert info["planes"]["U"]["modes"].shape == (16,)
    main(["--device", "cpu", "demo", "--width", "16", "--height", "16"])
    assert not [m for m in sys.modules if m.split(".")[0] == "jax"]
    print("JAX-FREE OK")
""")


def test_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", JAX_BLOCKED], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "JAX-FREE OK" in proc.stdout
