"""The sequence stream in plain Python: what the port's sequence runner
(`models/sequence.py`, `SequenceEncoder` and `encode_sequence`) must
write for the configurations the benchmark runs, over the frame
bitstream of `plainref/bitstream.py`.

Layout: one group of parameter sets for the whole sequence (VPS, SPS,
PPS: the frame bitstream's, with the MPM mode flag set and the SAO flag
set where the configuration runs SAO or CTB SAO), then an access unit a
frame: an access unit delimiter whose payload is the frame's index in
the sequence as a little-endian uint32, then the frame's NALs as
`bitstream.assemble` writes them (its CTB SAO NAL, then a slice a
plane), without its parameter sets.  Each slice carries the frame's QP;
the PPS carries the configuration's.

Departures from the published description (ITU-T H.265, 7.3.2 and
7.3.2.5), all the port's container, which the reference follows:

- the parameter sets are the port's own (a 0x4E48 tag and its fields in
  exp-Golomb), not the spec's VPS/SPS/PPS syntax;
- the delimiter (NAL type 35) carries the frame index, not the spec's
  3-bit pic_type and rbsp trailing bits;
- the SAO parameters ride their own NAL (type 39, which the spec gives
  to prefix SEI), and the slices are the port's (see
  `plainref/bitstream.py`).
"""

from __future__ import annotations

import struct

from plainref import bitstream

NAL_AUD = 35


def header(width: int, height: int, cfg: dict) -> bytes:
    """The sequence's VPS, SPS and PPS under configuration `cfg` (the
    keys of `EncoderConfig`)."""
    pk = dict(bit_depth=int(cfg["bit_depth"]),
              scan_idx=bitstream.SCAN_IDX[cfg["scan"]],
              rescale_flag=int(cfg["dequant_rescale"]),
              smoothing_flag=int(cfg["intra_smoothing"]),
              entropy_idx=bitstream.ENTROPY_IDX[cfg["entropy_coder"]],
              deblock_flag=int(cfg["deblock"]), mode_mpm_flag=1,
              sao_flag=int(bool(cfg["sao"] or cfg["sao_ctb"])))
    return b"".join(
        bitstream.wrap_nal(t, bitstream.write_params(
            width, height, int(cfg["block_size"]), int(cfg["qp"]), which,
            **pk))
        for which, t in enumerate((bitstream.NAL_VPS, bitstream.NAL_SPS,
                                   bitstream.NAL_PPS)))


def delimiter(index: int) -> bytes:
    """The access unit delimiter of the sequence's frame `index`."""
    return bitstream.wrap_nal(NAL_AUD, struct.pack("<I", index))


def after_delimiter(unit: bytes, index: int):
    """The bytes of access unit `unit` after the delimiter of frame
    `index`; None where it does not start with that delimiter."""
    aud = delimiter(index)
    return unit[len(aud):] if unit.startswith(aud) else None


def unit_of(index: int, width: int, height: int, cfg: dict,
            frame: bytes) -> bytes:
    """Frame `index`'s access unit from its single-frame stream
    `frame` (as `bitstream.assemble` writes it): the delimiter, then
    the frame's NALs after its parameter sets."""
    head = header(width, height, cfg)
    if not frame.startswith(head):
        raise ValueError("the frame's parameter sets are not the "
                         "sequence's (block size or SAO flag differ)")
    return delimiter(index) + frame[len(head):]


def access_unit(index: int, width: int, height: int, cfg: dict,
                levels: dict, modes: dict, sao_ctb: dict) -> bytes:
    """Frame `index`'s access unit from each plane's scan-packed levels,
    modes and CTB SAO parameters, in the shapes
    `encoder.encode_frames` gives them."""
    return unit_of(index, width, height, cfg, bitstream.assemble(
        width, height, cfg, levels, modes, sao_ctb))


def stream(width: int, height: int, cfg: dict, frames: list,
           first: int = 0) -> bytes:
    """The whole sequence: the header, then the access units of
    `frames` (`encoder.encode_frames`' dicts) from index `first`."""
    return header(width, height, cfg) + b"".join(
        access_unit(first + i, width, height, cfg, f["levels"], f["modes"],
                    f["sao_ctb"])
        for i, f in enumerate(frames))
