"""The port imports neither JAX nor the JAX package.

The GPU machine has no JAX, and the port keeps its own copies of the
host modules it needs, so `nanohevc_tpu_torch` (and `chip_smoke.py`)
import nothing from `nanohevc_tpu`, not even a module that imports no
JAX.  Checked twice: statically over the sources, and by running the
port in a process where importing jax or `nanohevc_tpu` raises.
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
SHARED: set[str] = set()    # modules of nanohevc_tpu the port may import


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
        return len(parts) == 1 or parts[1] not in SHARED
    return False


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


def test_scanner_catches_jax():
    assert _forbidden("jax.numpy")
    assert _forbidden("nanohevc_tpu.ops")
    assert _forbidden("nanohevc_tpu.models.all_intra")
    assert _forbidden("nanohevc_tpu.runtime.bitstream")
    assert _forbidden("nanohevc_tpu.config")
    assert _forbidden("nanohevc_tpu")
    assert not _forbidden("nanohevc_tpu_torch.runtime.bitstream")
    assert not _forbidden("torch")


JAX_BLOCKED = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "nanohevc_tpu")
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    class NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, NoJax())

    import numpy as np
    from nanohevc_tpu_torch import (
        create_test_frame,
        decode_frame,
        encode_frame_closed_loop,
        encode_frame_full,
    )
    from nanohevc_tpu_torch.cli import main
    from nanohevc_tpu_torch.config import EncoderConfig

    recon, info = encode_frame_full(create_test_frame(32, 32),
                                    EncoderConfig(), device="cpu")
    assert recon.y.data.shape == (32, 32)
    assert info["planes"]["Y"]["levels"].shape == (16, 64)
    cfg = EncoderConfig(mode_set="all", decision="satd", intra_smoothing=True)
    recon, info = encode_frame_full(create_test_frame(32, 32), cfg, device="cpu")
    assert info["planes"]["U"]["modes"].shape == (16,)
    for cfg in (EncoderConfig(), EncoderConfig(mode_set="all", decision="satd")):
        recon, bits = encode_frame_closed_loop(create_test_frame(24, 40), cfg,
                                               device="cpu")
        decoded = decode_frame(bits, device="cpu")
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(decoded, p).data, getattr(recon, p).data)
    main(["--device", "cpu", "demo", "--width", "16", "--height", "16"])
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
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
