"""Build the CUDA sources under `csrc/` with nvcc and load them (ctypes).

The library has a plain C interface (no PyTorch headers), so nvcc
builds it in seconds.  It is compiled at first use into
`build/nanohevc_tpu_torch/` at the root of the checkout, keyed by a hash
of the sources and flags, and loaded once per process.  Nothing but
the sources in this package goes into it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nanohevc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (not on PATH, not at /usr/local/cuda/bin/nvcc): "
        "the CUDA kernels of nanohevc_tpu_torch cannot be built"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


class BuildInfo:
    """What the last build did: library path, seconds, ptxas report."""

    def __init__(self, path: Path, seconds: float, log: str, cached: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.cached = cached


def build_library() -> BuildInfo:
    """Compile csrc/*.cu into one shared library unless it is current."""
    lib = BUILD_DIR / f"libnanohevc_tpu_torch_{source_hash()}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "", True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, proc.stderr, False)


@lru_cache(maxsize=None)
def load_library() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build if needed, load once, and declare the C signatures."""
    info = build_library()
    lib = ctypes.CDLL(str(info.path))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.nhv_table_ints.argtypes = []
    lib.nhv_table_ints.restype = i
    lib.nhv_upload_tables.argtypes = [p, i, i]
    lib.nhv_upload_tables.restype = i
    lib.nhv_slab_encode.argtypes = [
        p, i, i, i, i,              # plane, height, width, n, use_dst
        i, i, i, i, i, i, i,        # mf .. boundary
        p, p, p, p, i,              # recon, levels, modes, stream, device
    ]
    lib.nhv_slab_encode.restype = i
    return lib, info
