# Copy of nanohevc_tpu/runtime/build.py, building out of the source tree.
"""Build the native runtime shared libraries (lazy, cached).

g++ is invoked once per source change.  Each library goes into
`build/nanohevc_tpu_torch/runtime/` at the root of the checkout, named
by a hash of its source, never next to the sources.  It is written to
a temporary name and renamed into place, so processes that build the
same library at once each load a complete file.  No pip/network
involvement.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_NATIVE_DIR = Path(__file__).parent / "native"
_SRC = _NATIVE_DIR / "nanohevc_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nanohevc_tpu_torch" / "runtime"


def build_native(src: Path, force: bool = False) -> Path:
    """Compile `src` with g++ (if not built yet) and return the library."""
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{h}.so"
    if not force and lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-Wall",
             "-o", tmp, str(src)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_runtime(force: bool = False) -> Path:
    """Compile (if needed) and return the shared library path."""
    return build_native(_SRC, force)
