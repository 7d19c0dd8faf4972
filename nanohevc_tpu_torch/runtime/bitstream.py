# Copy of nanohevc_tpu/runtime/bitstream.py (only the import lines, the `span` blocks, `assemble_bitstream`, whose CABAC branch codes the levels in their scan order, and `write_sao_ctb_params`, which codes the tiles with array operations, differ).
"""Frame bitstream assembly/parsing over the native entropy codec.

Layout (framework-defined, spec-style framing):

  [NAL VPS][NAL SPS][NAL PPS][NAL slice Y][NAL slice U][NAL slice V]

Each slice payload: 20-byte little-endian header (plane_id u16,
block_size u16, qp u32, nb u32, modes_len u32, levels_len u32)
followed by the range-coded per-block intra modes and the range-coded
levels.  The per-slice qp overrides the PPS default — that is what
lets rate control vary QP frame by frame inside one stream (the HEVC
analog is slice_qp_delta).  All
NALs carry start codes, the 2-byte header, and emulation prevention
(stripped symmetrically on parse).  Implements the nal.py capability
the reference declares but never ships.

Note: the bitstream is fully invertible back to (modes, levels); pixel
-exact decode additionally requires the encoder's closed-loop
(reconstruction-fed) prediction mode, since reference-parity
prediction reads source neighbors the decoder does not have
(SURVEY §3.1).
"""

from __future__ import annotations

import struct
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from nanohevc_tpu_torch.runtime import entropy
from nanohevc_tpu_torch.utils.tracing import count, span


# Container format version, written as vps_version by the native
# runtime (nhr_write_params) and gated on decode: version 2 = the
# round-3 last-position residual syntax + 4-lane level checksum.
FORMAT_VERSION = 2

_SCAN_IDX = {"diag": 0, "horizontal": 1, "vertical": 2, "mode": 3}
_SCAN_NAME = {v: k for k, v in _SCAN_IDX.items()}
_ENTROPY_IDX = {"range": 0, "cabac": 1, "hevc-slice": 2}
_ENTROPY_NAME = {v: k for k, v in _ENTROPY_IDX.items()}


@lru_cache(maxsize=None)
def _np_scan_orders(n: int) -> "np.ndarray":
    """(3, n*n) int64: scan position -> raster index per scanIdx."""
    from nanohevc_tpu_torch.tables import (
        diag_scan_order,
        horizontal_scan_order,
        vertical_scan_order,
    )

    return np.stack([
        diag_scan_order(n).astype(np.int64),
        horizontal_scan_order(n).astype(np.int64),
        vertical_scan_order(n).astype(np.int64),
    ])


def _np_mode_scan_idx(modes: np.ndarray, n: int) -> np.ndarray:
    """Spec 7.4.9.11 scanIdx per block (numpy twin of ops.mode_scan_idx)."""
    modes = np.asarray(modes)
    if n not in (4, 8):
        return np.zeros(modes.shape, np.int64)
    sel = np.zeros(modes.shape, np.int64)
    sel[(modes >= 6) & (modes <= 14)] = 2    # near-horizontal -> vertical
    sel[(modes >= 22) & (modes <= 30)] = 1   # near-vertical -> horizontal
    return sel


def _slice_scan_sel(scan: str, modes, nb: int, n: int) -> np.ndarray:
    """(nb,) per-block scanIdx for one slice under the stream's scan."""
    if scan == "mode":
        if modes is None:
            raise ValueError("scan='mode' needs per-block modes")
        return _np_mode_scan_idx(np.asarray(modes), n)
    return np.full(nb, _SCAN_IDX[scan], np.int64)


def _np_unpack(packed: np.ndarray, sel: np.ndarray, n: int) -> np.ndarray:
    """(nb, n*n) scan-packed + per-block scanIdx -> (nb, n, n) raster."""
    orders = _np_scan_orders(n)
    inv = np.argsort(orders, axis=1)
    flat = np.take_along_axis(np.asarray(packed), inv[sel], axis=1)
    return flat.reshape(-1, n, n)


def _np_pack(raster: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """(nb, n, n) raster + per-block scanIdx -> (nb, n*n) scan-packed."""
    nb, n, _ = raster.shape
    orders = _np_scan_orders(n)
    return np.take_along_axis(raster.reshape(nb, n * n), orders[sel], axis=1)


def _mode_grid(
    nb: int, width: int, height: int, block_size: int, plane_id: int
) -> Optional[Tuple[int, int]]:
    """(nby, nbx) block grid for a slice, or None if nb fits neither
    the padded (closed-loop) nor the drop-partial (reference-parity)
    tiling of the SPS geometry.

    Encoder and decoder evaluate this same predicate from the same
    (nb, SPS dims, block size) inputs, so 'MPM when the grid is
    known' needs no extra signalling beyond the PPS flag.
    """
    pw, ph = (width, height) if plane_id == 0 else (
        (width + 1) // 2, (height + 1) // 2
    )
    cy, cx = -(-ph // block_size), -(-pw // block_size)
    if cy * cx == nb:
        return cy, cx
    fy, fx = ph // block_size, pw // block_size
    if fy * fx == nb:
        return fy, fx
    return None


def assemble_bitstream(
    width: int,
    height: int,
    qp: int,
    plane_levels: Dict[str, Tuple[np.ndarray, int]],
    plane_modes: Optional[Dict[str, np.ndarray]] = None,
    bit_depth: int = 8,
    scan: str = "diag",
    dequant_rescale: bool = False,
    intra_smoothing: bool = False,
    entropy_tiles: int = 1,
    entropy_coder: str = "range",
    deblock: bool = False,
    sao: Optional[Dict[str, tuple]] = None,
    sao_ctb: Optional[Dict[str, tuple]] = None,
) -> bytes:
    """Build a full frame bitstream.

    plane_levels maps plane name ("Y"/"U"/"V") to (levels (nb, ncoef)
    int32 scan-ordered, block_size); plane_modes optionally maps the
    same names to (nb,) int32 intra-mode indices.  bit_depth rides the
    SPS, scan order and the dequant-rescale flag ride the PPS, so the
    stream decodes without out-of-band config.  entropy_tiles > 1
    splits each level payload into independent context chunks coded on
    parallel host threads (self-describing; the parser needs no
    knowledge of the count).  entropy_coder="cabac" codes each
    slice's levels with the spec 9.3 CABAC engine and the 7.3.8.11
    residual_coding syntax (runtime/hevc.py) instead of the framework
    range coder; the choice is signalled in the PPS.
    """
    if entropy_coder not in _ENTROPY_IDX:
        raise ValueError(f"unknown entropy_coder: {entropy_coder}")
    if scan == "mode":
        # mode-dependent unpack needs the per-block modes at decode
        # time, so they must be coded for every plane in the stream
        missing = [
            p for p in plane_levels
            if not (plane_modes and p in plane_modes)
        ]
        if missing:
            raise ValueError(
                "scan='mode' requires coded per-block modes for every "
                f"plane; missing for {missing}"
            )
    first = next(iter(plane_levels.values()))
    pk = dict(
        bit_depth=bit_depth,
        scan_idx=_SCAN_IDX[scan],
        rescale_flag=int(dequant_rescale),
        smoothing_flag=int(intra_smoothing),
        entropy_idx=_ENTROPY_IDX[entropy_coder],
        deblock_flag=int(deblock),
        mode_mpm_flag=1,  # MPM mode syntax wherever the grid is known
        # a stream losing its SAO NAL must fail decode, not decode
        # unfiltered (covers per-frame and CTB-granular variants)
        sao_flag=int(bool(sao) or bool(sao_ctb)),
    )
    out = [
        entropy.wrap_nal(entropy.NAL_VPS, entropy.write_params(width, height, first[1], qp, 0, **pk)),
        entropy.wrap_nal(entropy.NAL_SPS, entropy.write_params(width, height, first[1], qp, 1, **pk)),
        entropy.wrap_nal(entropy.NAL_PPS, entropy.write_params(width, height, first[1], qp, 2, **pk)),
    ]
    if sao and sao_ctb:
        raise ValueError("pass per-frame sao OR sao_ctb, not both")
    if sao:
        with span("entropy.sao"):
            out.append(entropy.wrap_nal(entropy.NAL_SAO, write_sao_params(sao)))
    if sao_ctb:
        with span("entropy.sao"):
            out.append(entropy.wrap_nal(
                entropy.NAL_SAO, write_sao_ctb_params(sao_ctb, bit_depth)
            ))
    plane_ids = {"Y": 0, "U": 1, "V": 2}
    for name, (levels, block_size) in plane_levels.items():
        levels = np.ascontiguousarray(levels, dtype=np.int32)
        nb, ncoef = levels.shape
        if plane_modes and name in plane_modes:
            modes = np.ascontiguousarray(plane_modes[name], dtype=np.int32)
            grid = _mode_grid(nb, width, height, block_size,
                              plane_ids[name])
            with span("entropy.modes"):
                if grid is not None:
                    mpay = entropy.encode_modes(modes, *grid)
                else:
                    mpay = entropy.encode_levels(modes.reshape(nb, 1))
        else:
            modes = None
            mpay = b""
        if entropy_coder == "cabac":
            from nanohevc_tpu_torch.runtime import hevc

            with span("entropy.scan"):
                sel = _slice_scan_sel(scan, modes, nb, block_size)
            with span("entropy.residual"):
                payload = hevc.encode_plane_cabac_scan(
                    levels, sel, c_idx=0 if name == "Y" else 1, qp=qp
                )
            count("entropy.scan_order_blocks", nb)
        elif entropy_coder == "hevc-slice":
            # full spec-syntax slice: modes ride IN the CTU structure
            # (8.4.2.2 MPM syntax), so no separate mode payload exists
            from nanohevc_tpu_torch.runtime import hevc

            if modes is None:
                raise ValueError(
                    "entropy_coder='hevc-slice' needs per-block modes "
                    f"for every plane; missing for {name}"
                )
            grid = _mode_grid(nb, width, height, block_size,
                              plane_ids[name])
            if grid is None:
                raise ValueError(
                    "entropy_coder='hevc-slice' needs the block grid; "
                    f"nb={nb} does not tile the SPS geometry for {name}"
                )
            with span("entropy.scan"):
                sel = _slice_scan_sel(scan, modes, nb, block_size)
                raster = _np_unpack(levels, sel, block_size)
            with span("entropy.residual"):
                payload = hevc.encode_slice_hevc(raster, modes, *grid, qp=qp)
            mpay = b""
        else:
            with span("entropy.residual"):
                payload = entropy.encode_levels(levels, tiles=entropy_tiles)
        header = struct.pack(
            "<HHIIII", plane_ids[name], block_size, qp, nb,
            len(mpay), len(payload),
        )
        out.append(entropy.wrap_nal(entropy.NAL_SLICE, header + mpay + payload))
    return b"".join(out)


def write_sao_params(sao: Dict[str, tuple]) -> bytes:
    """Per-frame SAO parameter payload: magic "NS" + count, then
    7 bytes per plane (plane_id, type 0-5, band_pos 0-31, 4 signed
    offsets).  Offsets fit int8 at every bit depth (cap 31)."""
    plane_ids = {"Y": 0, "U": 1, "V": 2}
    out = [b"NS", struct.pack("<B", len(sao))]
    for name, (type_idx, band_pos, offsets) in sao.items():
        o = [int(v) for v in offsets]
        out.append(struct.pack(
            "<BBBbbbb", plane_ids[name], int(type_idx), int(band_pos), *o
        ))
    return b"".join(out)


class _TileBitWriter:
    """MSB-first bit packer for the CTB-SAO tile syntax."""

    def __init__(self):
        self._acc = 0
        self._n = 0
        self._out = bytearray()

    def put(self, value: int, width: int) -> None:
        self._acc = (self._acc << width) | (value & ((1 << width) - 1))
        self._n += width
        while self._n >= 8:
            self._n -= 8
            self._out.append((self._acc >> self._n) & 0xFF)

    def bytes(self) -> bytes:
        if self._n:
            return bytes(self._out) + bytes(
                [(self._acc << (8 - self._n)) & 0xFF]
            )
        return bytes(self._out)


class _TileBitReader:
    """MSB-first reader; raises CorruptBitstreamError on overrun."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def get(self, width: int) -> int:
        v = 0
        for _ in range(width):
            byte, bit = divmod(self._pos, 8)
            if byte >= len(self._data):
                raise entropy.CorruptBitstreamError(
                    "CTB-SAO payload overran its coded bytes"
                )
            v = (v << 1) | ((self._data[byte] >> (7 - bit)) & 1)
            self._pos += 1
        return v


def _signed(v: int, width: int) -> int:
    return v - (1 << width) if v >= (1 << (width - 1)) else v


def write_sao_ctb_params(
    sao_ctb: Dict[str, tuple], bit_depth: int = 8
) -> bytes:
    """CTB-granular SAO NAL payload: magic "NC" + plane count, then per
    plane a header (plane_id u8, tile_log2 u8, nty u16, ntx u16,
    offset-field width u8, payload byte length u32) and the bit-packed
    tile syntax in raster order:

      merge_left (1 bit, tiles with a left neighbor)
      merge_up   (1 bit, if not merged and an up neighbor exists)
      else: type 2 bits (0=off, 1=EO, 2=BO);
            EO: eo_class 2 bits;  BO: band_pos 5 bits;
            then 4 offsets, two's complement off_w bits each.

    Merge flags are DERIVED here by exact equality of final neighbor
    parameters (the decoder copies the neighbor's reconstructed
    params), so any upstream RD merge decision is automatically
    consistent.  sao_ctb maps plane name to (tile, type_map (nty,ntx),
    band_map, off_map (nty,ntx,4)) int arrays.

    The tiles are coded with array operations: every syntax element of
    a tile is a (value, width) field, width 0 where the element is
    absent, and the fields are expanded MSB-first into bits in raster
    order and packed, the last byte zero-padded.
    """
    from nanohevc_tpu_torch.ref.sao import SAO_BO, SAO_OFF

    plane_ids = {"Y": 0, "U": 1, "V": 2}
    off_w = min(bit_depth, 10) - 4        # 4 bits at 8-bit (cap 7)
    out = [b"NC", struct.pack("<B", len(sao_ctb))]
    for name, (tile, tmap, bmap, omap) in sao_ctb.items():
        tmap = np.asarray(tmap, np.int64)
        bmap = np.asarray(bmap, np.int64)
        omap = np.asarray(omap, np.int64)
        nty, ntx = tmap.shape
        if tile & (tile - 1) or not 8 <= tile <= 256:
            raise ValueError(f"sao tile must be a power of two: {tile}")

        # A tile merges with a neighbor whose type, band and offsets are
        # all equal to its own, whatever the type.
        par = np.concatenate([tmap[..., None], bmap[..., None], omap], -1)
        left = np.zeros((nty, ntx), bool)
        left[:, 1:] = (par[:, 1:] == par[:, :-1]).all(-1)
        up = np.zeros((nty, ntx), bool)
        up[1:] = (par[1:] == par[:-1]).all(-1) & ~left[1:]
        coded = ~(left | up)
        on = coded & (tmap != SAO_OFF)
        bo = tmap == SAO_BO
        # Fields of a tile: merge_left, merge_up, type, EO class or band,
        # then the offsets.
        value = np.empty((nty, ntx, 4 + omap.shape[-1]), np.int64)
        width = np.zeros_like(value)
        value[..., 0], width[:, 1:, 0] = left, 1
        value[..., 1], width[1:, :, 1] = up, ~left[1:]
        value[..., 2] = np.where(bo, 2, tmap != SAO_OFF)
        width[..., 2] = 2 * coded
        value[..., 3] = np.where(bo, bmap, tmap - 1)
        width[..., 3] = np.where(bo, 5, 2) * on
        value[..., 4:], width[..., 4:] = omap, off_w * on[..., None]
        # One entry a bit: its field's value shifted by the bits of the
        # field that follow it.
        width = width.reshape(-1)
        end = np.repeat(np.cumsum(width), width)
        shift = end - 1 - np.arange(end.size)
        bits = (np.repeat(value.reshape(-1), width) >> shift) & 1
        payload = np.packbits(bits).tobytes()
        out.append(struct.pack(
            "<BBHHBI", plane_ids[name], tile.bit_length() - 1,
            nty, ntx, off_w, len(payload),
        ))
        out.append(payload)
    return b"".join(out)


def parse_sao_ctb_params(payload: bytes) -> Dict[str, tuple]:
    """Inverse of write_sao_ctb_params, defensive against corruption."""
    from nanohevc_tpu_torch.ref.sao import SAO_BO, SAO_EO0, SAO_OFF

    names = {0: "Y", 1: "U", 2: "V"}
    if len(payload) < 3 or payload[:2] != b"NC":
        raise entropy.CorruptBitstreamError("bad CTB-SAO NAL magic")
    count = payload[2]
    if count > 3:
        raise entropy.CorruptBitstreamError(
            f"corrupt CTB-SAO NAL: plane count {count}"
        )
    pos = 3
    sao: Dict[str, tuple] = {}
    for _ in range(count):
        if pos + 11 > len(payload):
            raise entropy.CorruptBitstreamError("truncated CTB-SAO header")
        pid, tile_log2, nty, ntx, off_w, nbytes = struct.unpack_from(
            "<BBHHBI", payload, pos
        )
        pos += 11
        if (pid > 2 or not 3 <= tile_log2 <= 8 or not 1 <= off_w <= 8
                or nty == 0 or ntx == 0 or nty * ntx > 1 << 20):
            raise entropy.CorruptBitstreamError(
                f"corrupt CTB-SAO header: plane={pid} tile_log2={tile_log2}"
            )
        br = _TileBitReader(payload[pos : pos + nbytes])
        pos += nbytes
        tmap = np.zeros((nty, ntx), np.int32)
        bmap = np.zeros((nty, ntx), np.int32)
        omap = np.zeros((nty, ntx, 4), np.int32)
        for ty in range(nty):
            for tx in range(ntx):
                if tx > 0 and br.get(1):
                    tmap[ty, tx] = tmap[ty, tx - 1]
                    bmap[ty, tx] = bmap[ty, tx - 1]
                    omap[ty, tx] = omap[ty, tx - 1]
                    continue
                if ty > 0 and br.get(1):
                    tmap[ty, tx] = tmap[ty - 1, tx]
                    bmap[ty, tx] = bmap[ty - 1, tx]
                    omap[ty, tx] = omap[ty - 1, tx]
                    continue
                code = br.get(2)
                if code == 0:
                    continue
                if code == 3:
                    raise entropy.CorruptBitstreamError(
                        "corrupt CTB-SAO tile: reserved type code 3"
                    )
                if code == 2:
                    tmap[ty, tx] = SAO_BO
                    bmap[ty, tx] = br.get(5)
                else:
                    tmap[ty, tx] = SAO_EO0 + br.get(2)
                for k in range(4):
                    omap[ty, tx, k] = _signed(br.get(off_w), off_w)
        sao[names[pid]] = (1 << tile_log2, tmap, bmap, omap)
    return sao


def parse_sao_params(payload: bytes) -> Dict[str, tuple]:
    """Inverse of write_sao_params, defensive against corruption."""
    names = {0: "Y", 1: "U", 2: "V"}
    if len(payload) < 3 or payload[:2] != b"NS":
        raise entropy.CorruptBitstreamError("bad SAO NAL magic")
    count = payload[2]
    if count > 3 or len(payload) < 3 + 7 * count:
        raise entropy.CorruptBitstreamError(
            f"corrupt SAO NAL: count={count} len={len(payload)}"
        )
    sao: Dict[str, tuple] = {}
    for i in range(count):
        pid, t, pos, o0, o1, o2, o3 = struct.unpack_from(
            "<BBBbbbb", payload, 3 + 7 * i
        )
        if pid > 2 or t > 5 or pos > 31:
            raise entropy.CorruptBitstreamError(
                f"corrupt SAO params: plane={pid} type={t} band_pos={pos}"
            )
        sao[names[pid]] = (t, pos, np.array([o0, o1, o2, o3], np.int32))
    return sao


def _split_nals(data: bytes) -> List[Tuple[int, bytes]]:
    """Split on start codes; return (nal_type, unescaped payload) pairs."""
    # find start codes (00 00 01, optionally preceded by 00)
    starts = []
    i = 0
    while i + 3 <= len(data):
        if data[i : i + 3] == b"\x00\x00\x01":
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    nals = []
    for k, s in enumerate(starts):
        e = len(data)
        if k + 1 < len(starts):
            e = starts[k + 1] - 3
            if e > s and data[e - 1 : e] == b"\x00":  # 4-byte start code's zero
                e -= 1
        raw = data[s:e]
        nal_type = (raw[0] >> 1) & 0x3F
        payload = _unescape(raw[2:])
        nals.append((nal_type, payload))
    return nals


def _unescape(b: bytes) -> bytes:
    """Remove emulation_prevention_three_bytes (00 00 03 xx -> 00 00 xx)."""
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(b):
        v = b[i]
        if zeros >= 2 and v == 3 and i + 1 < len(b) and b[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(v)
        zeros = zeros + 1 if v == 0 else 0
        i += 1
    return bytes(out)


class _BitReader:
    """MSB-first bit reader with exp-Golomb (mirrors the C++ writer)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bit(self) -> int:
        byte = self.data[self.pos >> 3] if (self.pos >> 3) < len(self.data) else 0
        b = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bit() == 0:
            # Reading past the payload means an appended optional field
            # is absent in an older stream: it reads as 0, the default.
            if self.pos > 8 * len(self.data):
                return 0
            zeros += 1
            if zeros > 64:
                raise ValueError("malformed exp-Golomb")
        v = 1
        for _ in range(zeros):
            v = (v << 1) | self.bit()
        return v - 1


def parse_params(payload: bytes) -> dict:
    """Decode a parameter-set RBSP written by nhr_write_params."""
    r = _BitReader(payload)
    magic = r.bits(16)
    if magic != 0x4E48:
        raise ValueError(f"bad parameter-set magic: {magic:#x}")
    which = r.bits(8)
    if which == 0:
        return {"type": "vps", "version": r.ue(), "reserved": r.ue()}
    if which == 1:
        return {
            "type": "sps",
            "width": r.ue(),
            "height": r.ue(),
            "block_size": r.ue(),
            "chroma_format_idc": r.ue(),
            "bit_depth_luma_minus8": r.ue(),
        }
    pps = {
        "type": "pps",
        "qp": r.ue(),
        "scan_idx": r.ue(),
        "dequant_rescale": bool(r.ue()),
        "intra_smoothing": bool(r.ue()),
        # Streams from before the CABAC option lack this field; their
        # rbsp stop bit reads as ue()==0 == "range", the old default.
        "entropy_idx": r.ue(),
        # Appended later still; absent reads as ue()==0 == off.
        "deblock": bool(r.ue()),
        # MPM intra-mode syntax; absent (older streams) == generic.
        "mode_mpm": bool(r.ue()),
        # SAO expected: when set the decoder must find the frame's SAO
        # NAL (parse_bitstream checks); absent (older streams) == off.
        "sao_enabled": bool(r.ue()),
    }
    if pps["entropy_idx"] not in _ENTROPY_NAME:
        raise ValueError(f"bad PPS entropy_idx: {pps['entropy_idx']}")
    return pps


def parse_bitstream(data: bytes) -> Dict[str, dict]:
    """Inverse of assemble_bitstream.

    Returns {plane: {"levels": (nb, ncoef) int32, "modes": (nb,) int32
    or None, "block_size": int}}.
    """
    names = {0: "Y", 1: "U", 2: "V"}
    planes: Dict[str, dict] = {}
    for nal_type, payload in _split_nals(data):
        if nal_type == entropy.NAL_VPS:
            v = parse_params(payload).get("version")
            if v != FORMAT_VERSION:
                raise entropy.CorruptBitstreamError(
                    f"bitstream container format version {v}; this build "
                    f"reads version {FORMAT_VERSION} (the residual syntax "
                    "and level checksum changed) — re-encode the source "
                    "with this framework version"
                )
            continue
        if nal_type in (entropy.NAL_SPS, entropy.NAL_PPS):
            planes.setdefault("params", {}).update(parse_params(payload))
            continue
        if nal_type == entropy.NAL_SAO:
            # one NAL slot, two formats: "NS" per-frame params, "NC"
            # CTB-granular tile maps (magic-dispatched)
            if payload[:2] == b"NC":
                planes.setdefault("params", {})["sao_ctb"] = (
                    parse_sao_ctb_params(payload)
                )
            else:
                planes.setdefault("params", {})["sao"] = (
                    parse_sao_params(payload)
                )
            continue
        if nal_type != entropy.NAL_SLICE:
            continue
        plane_id, block_size, qp, nb, mlen, plen = struct.unpack(
            "<HHIIII", payload[:20]
        )
        # Header sanity before any allocation: a corrupted nb/mlen/plen
        # must raise, not drive a multi-GiB np.empty (fuzz-found).
        if plane_id > 2 or block_size not in (4, 8, 16, 32):
            raise entropy.CorruptBitstreamError(
                f"corrupt slice header: plane_id={plane_id} "
                f"block_size={block_size}"
            )
        if 20 + mlen + plen > len(payload) or nb > (1 << 22):
            raise entropy.CorruptBitstreamError(
                f"corrupt slice header: nb={nb} mlen={mlen} plen={plen} "
                f"exceed payload ({len(payload)} bytes)"
            )
        # Bound the decode allocation by the geometry the SPS implies
        # (param sets precede slices in every assembled stream): a
        # corrupt nb must not drive a multi-GiB np.empty at large block
        # sizes, where the flat 1<<22 cap alone still allows ~16 GiB.
        params = planes.get("params", {})
        if "width" in params and "height" in params:
            pw, ph = params["width"], params["height"]
            if plane_id > 0:  # 4:2:0 chroma planes at half resolution
                pw, ph = (pw + 1) // 2, (ph + 1) // 2
            max_nb = -(-pw // block_size) * -(-ph // block_size)
            if nb > max_nb:
                raise entropy.CorruptBitstreamError(
                    f"corrupt slice header: nb={nb} exceeds the "
                    f"{max_nb} blocks implied by the SPS geometry"
                )
        elif nb * block_size * block_size > (1 << 26):
            raise entropy.CorruptBitstreamError(
                f"corrupt slice header: nb={nb} at block_size="
                f"{block_size} with no SPS geometry in stream"
            )
        modes = None
        off = 20
        if mlen:
            grid = None
            if params.get("mode_mpm") and "width" in params:
                grid = _mode_grid(nb, params["width"], params["height"],
                                  block_size, plane_id)
            if grid is not None:
                modes = entropy.decode_modes(
                    payload[off : off + mlen], *grid
                )
            else:
                modes = entropy.decode_levels(
                    payload[off : off + mlen], nb, 1
                )[:, 0]
            off += mlen
        ent_name = _ENTROPY_NAME.get(params.get("entropy_idx", 0))
        if ent_name == "cabac":
            from nanohevc_tpu_torch.runtime import hevc

            scan = _SCAN_NAME.get(params.get("scan_idx", 0), "diag")
            if scan == "mode" and modes is None:
                raise entropy.CorruptBitstreamError(
                    "mode-dependent scan signalled but slice carries "
                    "no modes payload"
                )
            sel = _slice_scan_sel(scan, modes, nb, block_size)
            raster = hevc.decode_plane_cabac(
                payload[off : off + plen], nb, block_size, sel,
                c_idx=0 if plane_id == 0 else 1, qp=qp,
            )
            levels = _np_pack(raster, sel)
        elif ent_name == "hevc-slice":
            from nanohevc_tpu_torch.runtime import hevc

            if "width" not in params:
                raise entropy.CorruptBitstreamError(
                    "hevc-slice stream is missing its SPS geometry"
                )
            grid = _mode_grid(nb, params["width"], params["height"],
                              block_size, plane_id)
            if grid is None:
                raise entropy.CorruptBitstreamError(
                    f"hevc-slice: nb={nb} does not tile the SPS geometry"
                )
            raster, modes, slice_qp = hevc.decode_slice_hevc(
                payload[off : off + plen], *grid, block_size
            )
            if slice_qp != qp:
                raise entropy.CorruptBitstreamError(
                    f"slice_qp_delta gives QP {slice_qp} but the slice "
                    f"header says {qp} (corrupted stream)"
                )
            scan = _SCAN_NAME.get(params.get("scan_idx", 0), "diag")
            sel = _slice_scan_sel(scan, modes, nb, block_size)
            levels = _np_pack(raster, sel)
        else:
            levels = entropy.decode_levels(
                payload[off : off + plen], nb, block_size * block_size
            )
        planes[names[plane_id]] = {
            "levels": levels,
            "modes": modes,
            "block_size": block_size,
            "qp": qp,
        }
    return planes
