"""The port imports neither JAX nor the JAX package, and its layers
import one way.

The GPU machine has no JAX, and the port keeps its own copies of the
host modules it needs, so `nanohevc_tpu_torch` (and `chip_smoke.py`)
import nothing from `nanohevc_tpu`, not even a module that imports no
JAX.  Checked twice: statically over the sources (every module of the
package, the sequence runner's included, and `chip_smoke.py`), and by
running the port in a process where importing jax or `nanohevc_tpu`
raises: an open-loop and a closed-loop frame (one with deblocking and
CTB SAO), the CLI's demo, an `encode --rdo --rdoq` and an `encode
--hevc-export`, a 2-frame closed-loop sequence encoded and decoded,
and an open-loop and a closed-loop batch on a 2 x 2 mesh of "cpu"
entries (`parallel`).

The layers: `models/` imports `kernels/`, which imports `ops/`; no
module of `kernels/` imports `models`, `parallel`, `cli` or `runtime`,
and no module of `ops/` imports those or `kernels`, at module level or
inside a function (`test_layers_import_one_way`, statically).
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


# Layers each lower layer of the port must not import.
ABOVE = {
    "kernels": ("models", "parallel", "cli", "runtime"),
    "ops": ("kernels", "models", "parallel", "cli", "runtime"),
}


def _top_names() -> dict:
    """Name -> layer of every name the package's `__init__` imports
    (`from nanohevc_tpu_torch import encode_frame_full` reaches the
    models)."""
    tree = ast.parse((PORT / "__init__.py").read_text())
    return {alias.asname or alias.name: node.module.split(".")[1]
            for node in tree.body if isinstance(node, ast.ImportFrom)
            and (node.module or "").startswith("nanohevc_tpu_torch.")
            for alias in node.names}


def _port_layers(source: str, package: str):
    """The layer (the part after `nanohevc_tpu_torch.`) of every port
    module that `source` imports, at any depth, relative imports
    resolved against `package`."""
    top = _top_names()

    def layers(module, names=()):
        parts = module.split(".")
        if parts[0] != "nanohevc_tpu_torch":
            return
        if len(parts) > 1:
            yield parts[1]
        else:
            for name in names:
                yield top.get(name, name)

    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield from layers(alias.name)
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:
                base = package.split(".")
                base = base[:len(base) + 1 - node.level]
                module = ".".join(base + ([module] if module else []))
            yield from layers(module, [a.name for a in node.names])


def _layer_files():
    return [p for layer in ABOVE for p in sorted((PORT / layer).glob("*.py"))]


@pytest.mark.parametrize("path", _layer_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_layers_import_one_way(path):
    layer = path.parent.name
    bad = sorted(set(_port_layers(path.read_text(),
                                  f"nanohevc_tpu_torch.{layer}"))
                 & set(ABOVE[layer]))
    assert bad == [], f"{layer}/{path.name} imports {bad}"


def test_layer_scanner_catches_upward_imports():
    src = textwrap.dedent("""
        import torch
        from nanohevc_tpu_torch import ops, encode_frame_closed_loop
        from . import wavefront

        def f():
            import nanohevc_tpu_torch.runtime.hevc
            from nanohevc_tpu_torch.models.all_intra import encode_plane_full
            from ..parallel import mesh
            from nanohevc_tpu_torch import cli
    """)
    got = list(_port_layers(src, "nanohevc_tpu_torch.ops"))
    assert got == ["ops", "models", "ops", "runtime", "models", "parallel",
                   "cli"]
    assert _layer_files()


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
    cfg = EncoderConfig(deblock=True, sao_ctb=True, sao_tile=16)
    recon, bits = encode_frame_closed_loop(create_test_frame(24, 40), cfg,
                                           device="cpu")
    decoded = decode_frame(bits, device="cpu")
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(decoded, p).data, getattr(recon, p).data)
    main(["--device", "cpu", "demo", "--width", "16", "--height", "16"])

    import torch
    from nanohevc_tpu_torch.parallel import (
        make_batch_encoder,
        make_closed_loop_encoder,
        make_mesh,
    )
    mesh = make_mesh(["cpu"] * 4, space=2)
    planes = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (4, 24, 32)).astype(np.int32))
    for make in (make_batch_encoder, make_closed_loop_encoder):
        on_mesh = make(EncoderConfig(), mesh)(planes, 22)
        alone = make(EncoderConfig())(planes, 22)
        for k in ("recon", "levels", "modes"):
            assert torch.equal(on_mesh[k], alone[k]), k

    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "f.yuv"), os.path.join(tmp, "f.bin")
        with open(src, "wb") as f:
            f.write(create_test_frame(16, 32).to_yuv420p())
        main(["--device", "cpu", "encode", src, "--width", "32", "--height",
              "16", "--pipeline", "full", "--rdo", "--rdoq", "--bitstream", out])
        assert os.path.getsize(out) > 0
        hevc = os.path.join(tmp, "f.hevc")
        main(["--device", "cpu", "encode", src, "--width", "32", "--height",
              "16", "--pipeline", "closed-loop", "--hevc-export", hevc])
        assert os.path.getsize(hevc) > 0

    import os
    import tempfile
    from nanohevc_tpu_torch import decode_sequence, encode_sequence
    with tempfile.TemporaryDirectory() as tmp:
        frames = [create_test_frame(16, 32) for _ in range(2)]
        src, bits, dec = (os.path.join(tmp, f) for f in ("s.yuv", "s.bin", "d.yuv"))
        with open(src, "wb") as f:
            f.write(b"".join(fr.to_yuv420p() for fr in frames))
        res = encode_sequence(src, 32, 16, 2, EncoderConfig(), bits, batch=2,
                              closed_loop=True, device="cpu")
        assert res.frames == 2
        assert decode_sequence(bits, dec, device="cpu") == 2
        recon, _ = encode_frame_closed_loop(frames[0], EncoderConfig(), device="cpu")
        with open(dec, "rb") as f:
            assert f.read() == 2 * recon.to_yuv420p()
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
