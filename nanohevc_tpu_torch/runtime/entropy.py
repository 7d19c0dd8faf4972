# Copy of nanohevc_tpu/runtime/entropy.py (only the import lines differ).
"""ctypes bindings for the native entropy codec.

The host-side entropy stage: consumes the scan-ordered level tensor
produced on device (nanohevc_tpu.ops.scan_pack) and produces a
compressed byte payload; `decode_levels` restores it bit-exactly.
Implements the cabac.py capability the reference declares but never
ships (README.md:19-21).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from nanohevc_tpu_torch.runtime.build import build_runtime


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_runtime()))
    lib.nhr_encode_levels.restype = ctypes.c_int64
    lib.nhr_encode_levels.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.nhr_decode_levels.restype = ctypes.c_int64
    lib.nhr_decode_levels.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.nhr_encode_levels_tiled.restype = ctypes.c_int64
    lib.nhr_encode_levels_tiled.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.nhr_decode_levels_tiled.restype = ctypes.c_int64
    lib.nhr_decode_levels_tiled.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.nhr_encode_modes.restype = ctypes.c_int64
    lib.nhr_encode_modes.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.nhr_decode_modes.restype = ctypes.c_int64
    lib.nhr_decode_modes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.nhr_wrap_nal.restype = ctypes.c_int64
    lib.nhr_wrap_nal.argtypes = [
        ctypes.c_uint8,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.nhr_block_bits.restype = None
    lib.nhr_block_bits.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.nhr_write_params.restype = ctypes.c_int64
    lib.nhr_write_params.argtypes = [
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_uint8,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def encode_levels(levels: np.ndarray, tiles: int = 1) -> bytes:
    """(nb, ncoef) int32 scan-ordered levels -> compressed bytes.

    tiles > 1 splits the block axis into that many independent context
    chunks coded on parallel host threads (the HEVC tiles/WPP analog —
    CABAC-class coding is sequential within one context chain, so
    parallelism must come from independent chains).  The payload
    carries its own tile table; decode_levels is tile-count agnostic.
    Per-tile context reset costs <1% rate on frame-sized payloads.
    """
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    nb, ncoef = levels.shape
    cap = levels.size * 4 + 1024 + 6 * max(1, tiles)
    out = np.empty(cap, dtype=np.uint8)
    n = _lib().nhr_encode_levels_tiled(
        _i32ptr(levels), nb, ncoef, max(1, tiles), _u8ptr(out), cap
    )
    if n < 0:
        raise RuntimeError("entropy encoder output overflow")
    return out[:n].tobytes()


class CorruptBitstreamError(ValueError):
    """The payload failed integrity verification (truncated, garbage, or
    bit-flipped): the checksum trailer or decoder bounds tripped."""


def decode_levels(data: bytes, nb: int, ncoef: int) -> np.ndarray:
    """Inverse of encode_levels: bytes -> (nb, ncoef) int32 levels.

    Raises CorruptBitstreamError when the payload does not verify —
    silent mis-decodes are the failure mode of a real bitstream, so
    every payload carries a checksum trailer and the decoder bounds-
    checks its byte consumption (nanohevc_runtime.cpp).
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    buf = np.ascontiguousarray(buf)
    out = np.empty((nb, ncoef), dtype=np.int32)
    rc = _lib().nhr_decode_levels_tiled(
        _u8ptr(buf), len(data), nb, ncoef, _i32ptr(out)
    )
    if rc != 0:
        reasons = {
            1: "truncated (shorter than its checksum trailer)",
            2: "checksum mismatch",
            3: "decoder overran the coded bytes",
            4: "malformed tile table",
        }
        raise CorruptBitstreamError(
            f"corrupt level payload: {reasons.get(rc, rc)}"
        )
    return out


def encode_modes(modes: np.ndarray, nby: int, nbx: int) -> bytes:
    """(nby*nbx,) int32 intra modes (0-34, raster order) -> compressed
    bytes via spec 8.4.2.2 MPM prediction over the block grid.

    Neighbor-coherent mode fields (the output of any real mode
    decision) code in 1-3 bits/block instead of the ~14 the generic
    level syntax spends on a mode symbol."""
    modes = np.ascontiguousarray(modes, dtype=np.int32).reshape(-1)
    if modes.size != nby * nbx:
        raise ValueError(f"modes size {modes.size} != {nby}x{nbx}")
    cap = modes.size * 2 + 64
    out = np.empty(cap, dtype=np.uint8)
    n = _lib().nhr_encode_modes(_i32ptr(modes), nby, nbx, _u8ptr(out), cap)
    if n == -2:
        raise ValueError("intra mode out of range [0, 34]")
    if n < 0:
        raise RuntimeError("mode encoder output overflow")
    return out[:n].tobytes()


def decode_modes(data: bytes, nby: int, nbx: int) -> np.ndarray:
    """Inverse of encode_modes.  Raises CorruptBitstreamError when the
    payload fails its checksum or overruns."""
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    out = np.empty(nby * nbx, dtype=np.int32)
    rc = _lib().nhr_decode_modes(_u8ptr(buf), len(data), nby, nbx,
                                 _i32ptr(out))
    if rc != 0:
        raise CorruptBitstreamError(f"corrupt mode payload (rc={rc})")
    return out


def block_bits(levels: np.ndarray) -> np.ndarray:
    """Exact per-block rate of the adaptive coder, in fractional bits.

    (nb, ncoef) int32 scan-ordered levels -> (nb,) float64.  Replays
    the real context machinery (carry state across blocks, like the
    encoder); matches the byte count of encode_levels to < 0.1% —
    the ground truth for RD decisions and for calibrating the
    device-side rate model (ops/rate.py).
    """
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    nb, ncoef = levels.shape
    out = np.empty(nb, dtype=np.float64)
    _lib().nhr_block_bits(
        _i32ptr(levels), nb, ncoef,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


# NAL unit types (framework-defined numbering following spec layout).
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_SLICE = 1
NAL_SAO = 39    # per-frame SAO parameter NAL (prefix-SEI-style slot)


def wrap_nal(nal_type: int, payload: bytes) -> bytes:
    """Start code + NAL header + emulation-prevention-stuffed payload."""
    pay = np.frombuffer(payload, dtype=np.uint8)
    pay = np.ascontiguousarray(pay)
    cap = len(payload) + len(payload) // 2 + 16
    out = np.empty(cap, dtype=np.uint8)
    n = _lib().nhr_wrap_nal(nal_type, _u8ptr(pay), len(payload), _u8ptr(out), cap)
    if n == 0:
        raise RuntimeError("NAL wrap overflow")
    return out[:n].tobytes()


def write_params(
    width: int,
    height: int,
    block_size: int,
    qp: int,
    which: int,
    bit_depth: int = 8,
    scan_idx: int = 0,
    rescale_flag: int = 0,
    smoothing_flag: int = 0,
    entropy_idx: int = 0,
    deblock_flag: int = 0,
    mode_mpm_flag: int = 0,
    sao_flag: int = 0,
) -> bytes:
    """Parameter-set RBSP payload (0=VPS, 1=SPS, 2=PPS).

    SPS carries bit_depth_luma_minus8; PPS carries the scan index
    (0=diag, 1=horizontal, 2=vertical, 3=mode-dependent), the
    spec-gain dequant rescale flag, the entropy engine index
    (0=framework range coder, 1=spec 9.3 CABAC), the in-loop
    deblocking flag, the MPM mode-syntax flag, and the SAO flag —
    everything a decoder needs beyond the per-slice headers, so
    closed-loop streams stay self-contained for non-default configs.
    The SAO flag makes a dropped per-frame SAO NAL a loud decode
    error instead of a silently unfiltered reconstruction.
    """
    out = np.empty(256, dtype=np.uint8)
    n = _lib().nhr_write_params(
        width, height, block_size, qp, which,
        bit_depth, scan_idx, rescale_flag, smoothing_flag, entropy_idx,
        deblock_flag, mode_mpm_flag, sao_flag, _u8ptr(out), 256,
    )
    if n == 0:
        raise RuntimeError("params overflow")
    return out[:n].tobytes()
