"""Build the CUDA sources under `csrc/` with nvcc and load them (ctypes).

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface (no PyTorch headers), so nvcc builds it in seconds; all of
them are compiled at once, one nvcc process each.  The libraries go
into `build/nanohevc_tpu_torch/` at the root of the checkout, keyed by
a hash of the flags and of every file under `csrc/` (the shared
`*.cuh` headers included), and are loaded once per process.  Nothing
but the sources in this package goes into them.

The libraries of the search and wavefront kernels export
`nhv_table_ints` and `nhv_upload_tables` for their own `__constant__`
table, which `KernelLibrary` uploads once per device.  The row kernels
(K1, K5) take the transform matrices as immediates instead: before
compiling, `build_libraries` writes them from
`slab_pipeline.transform_table()` into a generated header,
`build/nanohevc_tpu_torch/include/transform_table.h`, whose text the
hash covers as it covers the sources.
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
GENERATED_DIR = BUILD_DIR / "include"
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
    # planes, batch, height, width, n, body, cost, fixed_mode, use_dst,
    # 7 QpScalars, strong_thresh, filter_mask, rdoq_scan, rdoq_tables,
    # rdoq_scalars (host), recon, levels, modes, work, grids, max_grid,
    # stream, device
    "wavefront": {"nhv_wavefront_encode":
                  [_P] + [_I] * 8 + [_I] * 7 + [_I, ctypes.c_ulonglong, _I]
                  + [_P] * 7 + [_I, _P, _I]},
    # blocks, refs, nb, n, 7 QpScalars, recon, levels, stream, device
    "fused_pipeline": {"nhv_fused_encode":
                       [_P, _P, _I, _I] + [_I] * 7 + [_P, _P, _P, _I]},
    # planes, batch, height, width, n, all_modes, use_dst, 7 QpScalars,
    # strong_thresh, filter_mask, rdoq_scan, tables, rdoq_scalars (host),
    # lam, log_gamma, ln2, recon, levels, modes, work, info, stream,
    # device; batch, height, width, n, all_modes (work ints; then work,
    # info, stream, device for the barriers); n1, n, count, log_gamma,
    # ln2, c1, c0, stream, device
    "wavefront_rd": {
        "nhv_wavefront_rd":
            [_P] + [_I] * 6 + [_I] * 7 + [_I, ctypes.c_ulonglong, _I]
            + [_P] * 2 + [ctypes.c_float] * 3 + [_P] * 4 + [_P, _P, _I],
        "nhv_wavefront_rd_work_ints": [_I] * 5,
        "nhv_wavefront_rd_barriers": [_I] * 5 + [_P, _P, _P, _I],
        "nhv_rd_prices": [_P, _P, _I] + [ctypes.c_float] * 2 + [_P] * 3
                         + [_I]},
    # residual, modes, batch, height, width, n, bit_depth, strong_thresh,
    # filter_mask, group_rows, max_grid, recon, work, grids, stream,
    # device; n, height, width, device
    "decode": {"nhv_wavefront_decode":
               [_P, _P] + [_I] * 6 + [ctypes.c_ulonglong] + [_I] * 2
               + [_P] * 4 + [_I],
               "nhv_decode_group_rows": [_I] * 4},
    # planes, batch, height, width, bit_depth, is_chroma, qp_scalar, qps,
    # out, stream, device
    "deblock": {"nhv_deblock": [_P] + [_I] * 6 + [_P, _P, _P, _I]},
    # src, rec, batch, height, width, tile_shift, bit_depth, mode, cap,
    # 4 prices, stats, type, band, offsets, counters, words, stream,
    # device; planes, type, band, offsets, batch, height, width,
    # tile_shift, bit_depth, out, stream, device
    "sao": {"nhv_sao_estimate": [_P, _P] + [_I] * 7
                                + [ctypes.c_float] * 4 + [_P] * 6 + [_P, _I],
            "nhv_sao_apply": [_P] * 4 + [_I] * 5 + [_P, _P, _I]},
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


def generated_headers() -> dict[str, str]:
    """{file name: text} of the headers generated for the build."""
    from nanohevc_tpu_torch.kernels.slab_pipeline import transform_table

    values = ", ".join(str(int(v)) for v in transform_table())
    return {"transform_table.h": (
        "// Generated by nanohevc_tpu_torch/kernels/build.py from\n"
        "// kernels/slab_pipeline.py::transform_table(); do not edit.\n"
        "#pragma once\n"
        f"#define NHV_TRANSFORM_TABLE {{{values}}}\n"
    )}


def source_hash() -> str:
    """Hash of the nvcc flags, every file under csrc/ and the generated
    headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in _CSRC.rglob("*") if p.is_file()):
        h.update(str(src.relative_to(_CSRC)).encode())
        h.update(src.read_bytes())
    for name, text in sorted(generated_headers().items()):
        h.update(name.encode())
        h.update(text.encode())
    return h.hexdigest()[:16]


def _write_generated_headers() -> None:
    GENERATED_DIR.mkdir(parents=True, exist_ok=True)
    for name, text in generated_headers().items():
        path = GENERATED_DIR / name
        if path.exists() and path.read_text() == text:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".h", dir=GENERATED_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)


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
    _write_generated_headers()
    for src in _sources():
        lib = library_path(src.stem)
        if lib.exists():
            infos[src.stem] = BuildInfo(lib, 0.0, "", True)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(GENERATED_DIR), "-o", tmp,
               str(src)]
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


def _load(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load the library at `path`, declare its table functions and
    `signatures` ({function: argument types}, all returning int)."""
    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "nhv_upload_tables"):      # a __constant__ table
        lib.nhv_table_ints.argtypes = []
        lib.nhv_table_ints.restype = _I
        lib.nhv_upload_tables.argtypes = [_P, _I, _I]
        lib.nhv_upload_tables.restype = _I
    for fn, args in signatures.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    return lib


@lru_cache(maxsize=None)
def load_library(name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build if needed, load library `name` once, declare its C signatures."""
    info = build_libraries()[name]
    return _load(info.path, SIGNATURES[name]), info


def edited_copy(out: Path, edits, csrc: Path | None = None,
                respell=None) -> Path:
    """Copy every file of `csrc` (this package's csrc/ by default) into
    out/csrc and apply `edits`, (file name, anchor, text put in its
    place): each anchor must occur once, or, where `respell` is given,
    its respelled form once (the text is then respelled alike).  Returns
    the copy, for the tools that time or instrument an edited kernel."""
    copy = out / "csrc"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(csrc or _CSRC, copy)
    for name, anchor, text in edits:
        path = copy / name
        src = path.read_text()
        if src.count(anchor) != 1 and respell is not None:
            anchor, text = respell(anchor), respell(text)
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found once: {anchor!r}")
        path.write_text(src.replace(anchor, text))
    return copy


def build_copy(csrc: Path, name: str, out: Path,
               signatures: dict | None = None
               ) -> tuple[ctypes.CDLL, BuildInfo]:
    """nvcc of csrc/<name>.cu (an edited copy, or another tree's
    sources) with this package's flags and generated headers into
    out/lib<name>.so; returns it loaded, with its table functions and
    `signatures` (by default SIGNATURES[name]) declared, and its build."""
    out.mkdir(parents=True, exist_ok=True)
    _write_generated_headers()
    lib_path = out / f"lib{name}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(GENERATED_DIR), "-o",
           str(lib_path), str(csrc / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    info = BuildInfo(lib_path, time.perf_counter() - t0, proc.stderr, False)
    sig = SIGNATURES[name] if signatures is None else signatures
    return _load(lib_path, sig), info


class KernelLibrary:
    """A loaded library and the devices whose constant table is set.

    `table` is None for a library without a constant table (the row
    kernels, whose tables are compiled in); `ensure_tables` then does
    nothing.  `built`, a (library, BuildInfo) from `build_copy`, stands
    in for this package's library `name`.
    """

    def __init__(self, name: str, table: np.ndarray | None = None,
                 built: tuple[ctypes.CDLL, BuildInfo] | None = None):
        self.name = name
        self.lib, self.build_info = built or load_library(name)
        self.table = None
        if table is not None:
            self.table = np.ascontiguousarray(table, dtype=np.int32)
            if self.table.size != self.lib.nhv_table_ints():
                raise RuntimeError(f"{name}: constant table layout differs "
                                   "from the kernel's")
        self.uploaded: set[int] = set()

    def ensure_tables(self, device: int) -> None:
        if self.table is None or device in self.uploaded:
            return
        rc = self.lib.nhv_upload_tables(self.table.ctypes.data,
                                        self.table.size, device)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: uploading the constant table failed: "
                f"CUDA error {rc}")
        self.uploaded.add(device)
