"""Build the CUDA sources under `csrc/` with nvcc and load them (ctypes).

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface (no PyTorch headers), so nvcc builds it in seconds; all of
them are compiled at once, one nvcc process each.  The libraries go
into `build/nanohevc_tpu_torch/` at the root of the checkout, keyed by
a hash of the flags and of every file under `csrc/` (the shared
`*.cuh` headers included), and are loaded once per process.  Nothing
but the sources in this package goes into them.

Every library exports `nhv_table_ints` and `nhv_upload_tables` for its
own `__constant__` table; `KernelLibrary` uploads that table once per
device.
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

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nanohevc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_I, _P = ctypes.c_int, ctypes.c_void_p
# plane, height, width, n, use_dst, mf .. boundary (7 QpScalars),
# recon, levels, modes, stream, device
_ENCODE_ARGS = [_P, _I, _I, _I, _I] + [_I] * 7 + [_P, _P, _P, _P, _I]
# Entry points of each library beyond the two table functions.
SIGNATURES = {
    "slab_pipeline": {"nhv_slab_encode": _ENCODE_ARGS},
    "mode_search": {"nhv_mode_search_encode": _ENCODE_ARGS},
    # planes, batch, height, width, n, body, use_dst, 7 QpScalars,
    # recon, levels, modes, work, grids, stream, device
    "wavefront": {"nhv_wavefront_encode":
                  [_P] + [_I] * 6 + [_I] * 7 + [_P] * 6 + [_I]},
    # blocks, refs, nb, n, 7 QpScalars, recon, levels, stream, device
    "fused_pipeline": {"nhv_fused_encode":
                       [_P, _P, _I, _I] + [_I] * 7 + [_P, _P, _P, _I]},
}


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
    """Hash of the nvcc flags and of every file under csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in _CSRC.rglob("*") if p.is_file()):
        h.update(str(src.relative_to(_CSRC)).encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_hash()}.so"


class BuildInfo:
    """What the build of one library did: path, seconds, ptxas report."""

    def __init__(self, path: Path, seconds: float, log: str, cached: bool):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.cached = cached


def build_libraries() -> dict[str, BuildInfo]:
    """Compile every csrc/*.cu that is not current, all at once.

    Returns {source stem: BuildInfo}; raises if any nvcc fails.
    """
    infos: dict[str, BuildInfo] = {}
    running = []
    for src in _sources():
        lib = library_path(src.stem)
        if lib.exists():
            infos[src.stem] = BuildInfo(lib, 0.0, "", True)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((src.stem, lib, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for stem, lib, tmp, cmd, proc, t0 in running:
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed (rc {proc.returncode}): "
                            f"{' '.join(cmd)}\n{err}")
            continue
        os.replace(tmp, lib)
        infos[stem] = BuildInfo(lib, seconds, err, False)
    if failures:
        raise RuntimeError("\n".join(failures))
    return infos


@lru_cache(maxsize=None)
def load_library(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build if needed, load library `name` once, declare its C signatures."""
    info = build_libraries()[name]
    lib = ctypes.CDLL(str(info.path))
    lib.nhv_table_ints.argtypes = []
    lib.nhv_table_ints.restype = _I
    lib.nhv_upload_tables.argtypes = [_P, _I, _I]
    lib.nhv_upload_tables.restype = _I
    for fn, args in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    return lib, info


class KernelLibrary:
    """A loaded library and the devices whose constant table is set."""

    def __init__(self, name: str, table: np.ndarray):
        self.name = name
        self.lib, self.build_info = load_library(name)
        self.table = np.ascontiguousarray(table, dtype=np.int32)
        if self.table.size != self.lib.nhv_table_ints():
            raise RuntimeError(f"{name}: constant table layout differs "
                               "from the kernel's")
        self.uploaded: set[int] = set()

    def ensure_tables(self, device: int) -> None:
        if device in self.uploaded:
            return
        rc = self.lib.nhv_upload_tables(self.table.ctypes.data,
                                        self.table.size, device)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: uploading the constant table failed: "
                f"CUDA error {rc}")
        self.uploaded.add(device)
