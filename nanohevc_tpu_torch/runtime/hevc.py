# Copy of nanohevc_tpu/runtime/hevc.py, building through runtime/build.py, with a scan-order entry.
"""ctypes bindings for the HEVC-conformant CABAC entropy stage.

The spec-true counterpart of runtime/entropy.py: the ITU-T H.265 9.3
arithmetic engine (rangeTabLPS state machine, 9.3.2.2 context init)
with the 7.3.8.11 residual_coding syntax, implemented in
native/hevc_cabac.cpp.  The reference project declares this capability
(reference README.md:97-100, cabac.py) and never ships it.

Levels enter in per-block RASTER layout — the syntax applies its own
spec 6.5.3 scan, selected per block (0 diag / 1 horizontal /
2 vertical), which is how the mode-dependent scan rule reaches the
coded stream.  `encode_plane_cabac_scan` takes them already in that
scan order, as the frame encoder packs them, and writes the same bytes.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np

from nanohevc_tpu_torch.runtime.build import build_native
from nanohevc_tpu_torch.runtime.entropy import CorruptBitstreamError

_SRC = Path(__file__).parent / "native" / "hevc_cabac.cpp"


def build_hevc_runtime(force: bool = False) -> Path:
    """Compile (if the source changed) and return the library path."""
    return build_native(_SRC, force)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_hevc_runtime()))
    lib.nhc_encode_plane.restype = ctypes.c_int64
    lib.nhc_encode_plane.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.nhc_encode_plane_scan.restype = ctypes.c_int64
    lib.nhc_encode_plane_scan.argtypes = lib.nhc_encode_plane.argtypes
    lib.nhc_decode_plane.restype = ctypes.c_int32
    lib.nhc_decode_plane.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.nhc_encode_slice.restype = ctypes.c_int64
    lib.nhc_encode_slice.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.nhc_decode_slice.restype = ctypes.c_int32
    lib.nhc_decode_slice.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.nhc_encode_slice420.restype = ctypes.c_int64
    lib.nhc_encode_slice420.argtypes = [
        i32p, i32p, i32p, i32p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        u8p, ctypes.c_int64,
    ]
    lib.nhc_decode_slice420.restype = ctypes.c_int32
    lib.nhc_decode_slice420.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, i32p, i32p, i32p, i32p, i32p, i32p,
    ]
    return lib


def _scan_indices(scan_idx, nb: int) -> np.ndarray:
    arr = np.asarray(scan_idx, dtype=np.uint8)
    if arr.ndim == 0:
        arr = np.full(nb, int(arr), np.uint8)
    if arr.shape != (nb,):
        raise ValueError(f"scan_idx must be scalar or ({nb},), got {arr.shape}")
    if arr.size and arr.max() > 2:
        raise ValueError("scan_idx values must be 0 (diag), 1 (horizontal) "
                         "or 2 (vertical)")
    return np.ascontiguousarray(arr)


def encode_plane_cabac(
    levels: np.ndarray, scan_idx, *, c_idx: int = 0, qp: int = 22
) -> bytes:
    """(nb, N, N) raster-layout int32 levels -> spec-CABAC payload.

    scan_idx: per-block spec scan (scalar or (nb,) array).  c_idx 0
    codes with the luma context set, >0 with chroma.  qp seeds the
    9.3.2.2 context initialization (I-slice initType).
    """
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    nb, n, n2 = levels.shape
    if n != n2 or n not in (4, 8, 16, 32):
        raise ValueError(f"levels must be (nb, N, N), N in 4/8/16/32: "
                         f"{levels.shape}")
    return _encode_plane(_lib().nhc_encode_plane, levels, n, scan_idx,
                         c_idx, qp)


def encode_plane_cabac_scan(
    levels: np.ndarray, scan_idx, *, c_idx: int = 0, qp: int = 22
) -> bytes:
    """(nb, N*N) scan-packed int32 levels -> spec-CABAC payload.

    Block b's word k is its coefficient at position k of its spec 6.5.3
    scan scan_idx[b] (by 4x4 sub-blocks above 4x4), the layout
    `bitstream._np_pack` gives.  The payload is `encode_plane_cabac`'s
    of the same blocks in raster layout.
    """
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    if levels.ndim != 2:
        raise ValueError(f"levels must be (nb, N*N): {levels.shape}")
    nb, ncoef = levels.shape
    n = {16: 4, 64: 8, 256: 16, 1024: 32}.get(ncoef)
    if n is None:
        raise ValueError(f"levels must be (nb, N*N), N in 4/8/16/32: "
                         f"{levels.shape}")
    return _encode_plane(_lib().nhc_encode_plane_scan, levels, n, scan_idx,
                         c_idx, qp)


def _encode_plane(entry, levels: np.ndarray, n: int, scan_idx, c_idx: int,
                  qp: int) -> bytes:
    """One of the plane entries on contiguous int32 levels of nb N x N
    blocks (validated by the caller) -> the payload."""
    nb = levels.shape[0]
    si = _scan_indices(scan_idx, nb)
    cap = levels.size * 4 + 1024
    out = np.empty(cap, dtype=np.uint8)
    r = entry(
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), nb,
        n.bit_length() - 1, int(c_idx),
        si.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(qp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if r < 0:
        raise RuntimeError(f"CABAC encoder failed: rc={r}")
    return out[:r].tobytes()


def decode_plane_cabac(
    data: bytes, nb: int, n: int, scan_idx, *, c_idx: int = 0, qp: int = 22
) -> np.ndarray:
    """Inverse of encode_plane_cabac -> (nb, N, N) raster levels.

    Raises CorruptBitstreamError when the payload does not parse (the
    terminate bins delimit each block, so truncation and garbage are
    detected structurally)."""
    if n not in (4, 8, 16, 32):
        raise ValueError(f"bad block size {n}")
    lg2 = n.bit_length() - 1
    si = _scan_indices(scan_idx, nb)
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    out = np.empty((nb, n * n), dtype=np.int32)
    rc = _lib().nhc_decode_plane(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data), nb,
        lg2, int(c_idx), si.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(qp), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        reasons = {
            2: "last-significant position out of range",
            3: "decoder overran the coded bytes",
            4: "terminate bin mismatch (truncated or desynchronized)",
        }
        raise CorruptBitstreamError(
            f"corrupt CABAC payload: {reasons.get(rc, rc)}"
        )
    return out.reshape(nb, n, n)


def encode_slice_hevc(
    levels: np.ndarray, modes: np.ndarray, nby: int, nbx: int, *,
    qp: int = 22
) -> bytes:
    """Spec-syntax slice payload (7.3.6.1 header + fixed-depth quadtree
    slice data; hevc_cabac.cpp slice-layer section).

    levels: (nby*nbx, N, N) raster-layout int32 (CU raster order);
    modes: (nby*nbx,) intra modes 0-34, coded in-CTU with the spec
    8.4.2.2 MPM syntax — no separate mode payload exists at this
    entropy level.  scanIdx is derived from each CU's coded mode per
    spec 7.4.9.11 (callers do not choose a scan).
    """
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    nb, n, n2 = levels.shape
    if n != n2 or n not in (4, 8, 16, 32):
        raise ValueError(f"levels must be (nb, N, N), N in 4/8/16/32: "
                         f"{levels.shape}")
    if nb != nby * nbx:
        raise ValueError(f"levels nb={nb} != grid {nby}x{nbx}")
    modes = np.ascontiguousarray(modes, dtype=np.int32).reshape(-1)
    if modes.size != nb:
        raise ValueError(f"modes size {modes.size} != nb {nb}")
    lg2 = n.bit_length() - 1
    cap = levels.size * 4 + 1024
    out = np.empty(cap, dtype=np.uint8)
    r = _lib().nhc_encode_slice(
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        modes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nby, nbx, lg2, int(qp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if r == -2:
        raise ValueError("bad slice args (mode out of range 0-34?)")
    if r < 0:
        raise RuntimeError(f"slice encoder failed: rc={r}")
    return out[:r].tobytes()


def encode_slice_hevc_420(
    levels_y: np.ndarray, modes_y: np.ndarray,
    levels_cb: np.ndarray, levels_cr: np.ndarray, modes_c: np.ndarray,
    nby: int, nbx: int, *, qp: int = 22
) -> bytes:
    """4:2:0 spec-syntax slice payload: luma + Cb/Cr transform units.

    levels_y: (nby*nbx, N, N) raster; levels_cb/cr: (nby*nbx, N/2, N/2)
    raster on the same CU grid; modes_c: the SHARED per-CU chroma mode
    (the spec codes one intra_chroma_pred_mode covering both chroma
    components, 7.3.8.5).  Each chroma mode must be representable: the
    CU's luma mode (DM_CHROMA) or a member of the substituted
    {planar, ver, hor, dc} candidate list (8.4.3) — a ValueError
    otherwise.  N >= 8 (chroma TB floor, log2TrafoSizeC >= 2).
    """
    levels_y = np.ascontiguousarray(levels_y, dtype=np.int32)
    nb, n, n2 = levels_y.shape
    if n != n2 or n not in (8, 16, 32):
        raise ValueError(f"luma levels must be (nb, N, N), N in 8/16/32: "
                         f"{levels_y.shape}")
    if nb != nby * nbx:
        raise ValueError(f"levels nb={nb} != grid {nby}x{nbx}")
    nc = n // 2
    levels_cb = np.ascontiguousarray(levels_cb, dtype=np.int32)
    levels_cr = np.ascontiguousarray(levels_cr, dtype=np.int32)
    for name, a in (("cb", levels_cb), ("cr", levels_cr)):
        if a.shape != (nb, nc, nc):
            raise ValueError(
                f"{name} levels must be ({nb}, {nc}, {nc}): {a.shape}"
            )
    modes_y = np.ascontiguousarray(modes_y, dtype=np.int32).reshape(-1)
    modes_c = np.ascontiguousarray(modes_c, dtype=np.int32).reshape(-1)
    if modes_y.size != nb or modes_c.size != nb:
        raise ValueError("modes size mismatch with CU grid")
    lg2 = n.bit_length() - 1
    cap = (levels_y.size + levels_cb.size + levels_cr.size) * 4 + 1024
    out = np.empty(cap, dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    r = _lib().nhc_encode_slice420(
        levels_y.ctypes.data_as(i32p), modes_y.ctypes.data_as(i32p),
        levels_cb.ctypes.data_as(i32p), levels_cr.ctypes.data_as(i32p),
        modes_c.ctypes.data_as(i32p), nby, nbx, lg2, int(qp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if r == -3:
        raise ValueError(
            "chroma mode not representable: each CU's chroma mode must "
            "equal its luma mode (DM) or one of the substituted "
            "{planar, ver, hor, dc} candidates (spec 8.4.3)"
        )
    if r == -2:
        raise ValueError("bad slice args (mode out of range 0-34?)")
    if r < 0:
        raise RuntimeError(f"slice encoder failed: rc={r}")
    return out[:r].tobytes()


def decode_slice_hevc_420(
    data: bytes, nby: int, nbx: int, n: int
) -> tuple:
    """Inverse of encode_slice_hevc_420 -> (levels_y (nb, N, N),
    modes_y (nb,), levels_cb, levels_cr (nb, N/2, N/2), modes_c (nb,),
    slice_qp).  Raises CorruptBitstreamError on a non-parsing payload."""
    if n not in (8, 16, 32):
        raise ValueError(f"bad block size {n}")
    lg2 = n.bit_length() - 1
    nc = n // 2
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    nb = nby * nbx
    levels_y = np.zeros((nb, n * n), dtype=np.int32)
    levels_cb = np.zeros((nb, nc * nc), dtype=np.int32)
    levels_cr = np.zeros((nb, nc * nc), dtype=np.int32)
    modes_y = np.zeros(nb, dtype=np.int32)
    modes_c = np.zeros(nb, dtype=np.int32)
    qp_out = np.zeros(1, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = _lib().nhc_decode_slice420(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        nby, nbx, lg2,
        levels_y.ctypes.data_as(i32p), modes_y.ctypes.data_as(i32p),
        levels_cb.ctypes.data_as(i32p), levels_cr.ctypes.data_as(i32p),
        modes_c.ctypes.data_as(i32p),
        qp_out.ctypes.data_as(i32p),
    )
    if rc != 0:
        reasons = {
            2: "bad geometry or last-significant position out of range",
            3: "decoder overran the coded bytes",
            4: "end_of_slice terminate mismatch",
            5: "invalid syntax (split/part_mode/mode out of model)",
            6: "slice_segment_header failed to parse",
        }
        raise CorruptBitstreamError(
            f"corrupt spec-slice payload: {reasons.get(rc, rc)}"
        )
    return (levels_y.reshape(nb, n, n), modes_y,
            levels_cb.reshape(nb, nc, nc), levels_cr.reshape(nb, nc, nc),
            modes_c, int(qp_out[0]))


def decode_slice_hevc(
    data: bytes, nby: int, nbx: int, n: int
) -> tuple:
    """Inverse of encode_slice_hevc -> (levels (nb, N, N) raster,
    modes (nb,), slice_qp).

    Raises CorruptBitstreamError when the header or CABAC payload does
    not parse (terminate bins delimit each CTU)."""
    if n not in (4, 8, 16, 32):
        raise ValueError(f"bad block size {n}")
    lg2 = n.bit_length() - 1
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    nb = nby * nbx
    levels = np.zeros((nb, n * n), dtype=np.int32)
    modes = np.zeros(nb, dtype=np.int32)
    qp_out = np.zeros(1, dtype=np.int32)
    rc = _lib().nhc_decode_slice(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        nby, nbx, lg2,
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        modes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qp_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        reasons = {
            2: "bad geometry or last-significant position out of range",
            3: "decoder overran the coded bytes",
            4: "end_of_slice terminate mismatch",
            5: "invalid syntax (split/part_mode/mode out of model)",
            6: "slice_segment_header failed to parse",
        }
        raise CorruptBitstreamError(
            f"corrupt spec-slice payload: {reasons.get(rc, rc)}"
        )
    return levels.reshape(nb, n, n), modes, int(qp_out[0])
