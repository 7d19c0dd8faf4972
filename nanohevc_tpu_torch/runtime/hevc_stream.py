# Copy of nanohevc_tpu/runtime/hevc_stream.py (only the import lines differ).
"""Standard-syntax HEVC stream export (Annex B byte stream).

The framework container (runtime/bitstream.py) uses framework-defined
parameter sets; this module writes the REAL ITU-T H.265 grammar so a
plane exports as a standalone monochrome bitstream a standard decoder
can parse:

  [VPS 7.3.2.1][SPS 7.3.2.2][PPS 7.3.2.3][IDR_W_RADL slice 7.3.6.1]

with 4-byte start codes, the 2-byte nal_unit_header (7.3.1.2), and
emulation prevention (7.4.2).  The slice payload is the spec-syntax
slice layer (hevc_cabac.cpp: header + fixed-depth coding_quadtree +
in-CTU mode syntax + residual_coding), which is grammar-exact for this
SPS/PPS configuration: monochrome (chroma_format_idc = 0),
CtbLog2SizeY = log2(N)+1, MinCbLog2SizeY = MaxTbLog2SizeY = log2(N),
SAO/PCM/AMP/scaling lists/tiles/WPP/cu_qp_delta/sign-hiding all off,
init_qp = 26, deblocking disabled in the PPS (the framework's loop
filters are container-level, not slice-level).

No HEVC decoder ships in this container, so conformance evidence is
the independent pure-Python parser in tests/test_hevc_stream.py, which
parses the VPS/SPS/PPS grammar field by field from the spec clauses
and decodes the slice bit-exactly.

Reference scope: the reference's roadmap names nal.py/cabac.py and
ships neither (reference README.md:97-100); this is the fully
spec-shaped end of that capability.
"""

from __future__ import annotations

import numpy as np

# nal_unit_type values (Table 7-1)
NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34


class _BW:
    """MSB-first bit writer with ue(v)/se(v) and rbsp trailing."""

    def __init__(self):
        self._bits: list[int] = []

    def u(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self._bits.append((v >> i) & 1)

    def ue(self, v: int) -> None:
        vp1 = v + 1
        nbits = vp1.bit_length()
        self.u(0, nbits - 1)
        self.u(vp1, nbits)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp_trailing(self) -> None:
        self.u(1, 1)
        while len(self._bits) % 8:
            self.u(0, 1)

    def bytes(self) -> bytes:
        assert len(self._bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self._bits), 8):
            b = 0
            for bit in self._bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _emulation_prevent(rbsp: bytes) -> bytes:
    """7.4.2: insert emulation_prevention_three_byte."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def wrap_nal_hevc(nal_type: int, rbsp: bytes) -> bytes:
    """4-byte start code + nal_unit_header (7.3.1.2) + escaped RBSP."""
    hdr = bytes([
        (nal_type & 0x3F) << 1,          # forbidden_zero(1) + type(6) hi
        1,                                # layer_id(6 lo bits)=0, tid+1=1
    ])
    return b"\x00\x00\x00\x01" + hdr + _emulation_prevent(rbsp)


def _profile_tier_level(bw: _BW, chroma_format_idc: int = 0,
                        bit_depth: int = 8) -> None:
    """7.3.3 general profile/tier/level, sub-layers absent.

    Monochrome streams use profile_idc 4 (format-range extensions)
    with the monochrome constraint flags — the profile that admits
    chroma_format_idc 0.  4:2:0 streams use the standard Main profile
    (idc 1) at 8-bit and Main 10 (idc 2) at 10-bit.
    """
    if chroma_format_idc == 1:
        profile_idc = 1 if bit_depth == 8 else 2
    else:
        profile_idc = 4
    bw.u(0, 2)                    # general_profile_space
    bw.u(0, 1)                    # general_tier_flag
    bw.u(profile_idc, 5)          # general_profile_idc
    compat = 1 << (31 - profile_idc)
    bw.u(compat, 32)              # general_profile_compatibility_flag[]
    bw.u(1, 1)                    # general_progressive_source_flag
    bw.u(0, 1)                    # general_interlaced_source_flag
    bw.u(1, 1)                    # general_non_packed_constraint_flag
    bw.u(1, 1)                    # general_frame_only_constraint_flag
    if profile_idc == 4:
        # RExt constraint flags: monochrome profile
        bw.u(1, 1)                # max_12bit
        bw.u(1, 1)                # max_10bit
        bw.u(1 if bit_depth <= 8 else 0, 1)   # max_8bit
        bw.u(1, 1)                # max_422chroma
        bw.u(1, 1)                # max_420chroma
        bw.u(1, 1)                # max_monochrome
        bw.u(1, 1)                # intra_constraint
        bw.u(0, 1)                # one_picture_only_constraint
        bw.u(0, 1)                # lower_bit_rate_constraint
        bw.u(0, 34)               # reserved_zero_34bits
    else:
        bw.u(0, 32)               # general_reserved_zero_43bits
        bw.u(0, 11)
    bw.u(0, 1)                    # general_inbld_flag (reserved)
    bw.u(120, 8)                  # general_level_idc = 4.0
    # max_sub_layers_minus1 == 0 -> no sub-layer fields


# Table 8-10 (ChromaArrayType == 1): qPi -> QpC.
_QPC_MAP = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34,
            37: 34, 38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qpc(qpi: int) -> int:
    """Spec 8.6.1 chroma QP derivation for 4:2:0."""
    if qpi < 30:
        return qpi
    if qpi in _QPC_MAP:
        return _QPC_MAP[qpi]
    return qpi - 6


def chroma_qp_offset_for(qp: int) -> int:
    """The pps_cb/cr_qp_offset making the decoder's chroma QP equal the
    luma QP — the framework quantizes chroma planes at the same QP, so
    the exported stream must steer the Table 8-10 compression (QpC <
    QpY above 29) back to identity.  A solution exists for every QP in
    0..51 with offsets in 0..6 (monotonicity of the map)."""
    for d in range(0, 13):
        if chroma_qpc(min(57, qp + d)) == qp:
            return d
    raise ValueError(f"no chroma QP offset maps QP {qp} to itself")


def write_vps_hevc() -> bytes:
    """7.3.2.1 video_parameter_set_rbsp, single layer."""
    bw = _BW()
    bw.u(0, 4)                    # vps_video_parameter_set_id
    bw.u(1, 1)                    # vps_base_layer_internal_flag
    bw.u(1, 1)                    # vps_base_layer_available_flag
    bw.u(0, 6)                    # vps_max_layers_minus1
    bw.u(0, 3)                    # vps_max_sub_layers_minus1
    bw.u(1, 1)                    # vps_temporal_id_nesting_flag
    bw.u(0xFFFF, 16)              # vps_reserved_0xffff_16bits
    _profile_tier_level(bw)
    bw.u(1, 1)                    # vps_sub_layer_ordering_info_present
    bw.ue(0)                      # vps_max_dec_pic_buffering_minus1[0]
    bw.ue(0)                      # vps_max_num_reorder_pics[0]
    bw.ue(0)                      # vps_max_latency_increase_plus1[0]
    bw.u(0, 6)                    # vps_max_layer_id
    bw.ue(0)                      # vps_num_layer_sets_minus1
    bw.u(0, 1)                    # vps_timing_info_present_flag
    bw.u(0, 1)                    # vps_extension_flag
    bw.rbsp_trailing()
    return bw.bytes()


def write_sps_hevc(width: int, height: int, n: int,
                   bit_depth: int = 8,
                   chroma_format_idc: int = 0) -> bytes:
    """7.3.2.2.1 seq_parameter_set_rbsp for the slice layer's model.

    width/height are the CODED (block-aligned) dimensions with a
    conformance window cropping back to the true size when they
    differ; CtbLog2SizeY = log2(n)+1, MinCb = MaxTb = n.
    chroma_format_idc: 0 (monochrome) or 1 (4:2:0 — conformance-window
    offsets are then in chroma units, so crops must be even).
    """
    if n < 8:
        # MinCbLog2SizeY >= 3 in the spec (7.4.3.2.1): 4x4 luma blocks
        # only exist as NxN partitions inside an 8x8 CB, a slice shape
        # this fixed-2Nx2N export does not model.
        raise ValueError(
            "standard-stream export needs block size >= 8 (HEVC min CB); "
            f"got {n}"
        )
    if chroma_format_idc not in (0, 1):
        raise ValueError("chroma_format_idc must be 0 (mono) or 1 (4:2:0)")
    lg2 = n.bit_length() - 1
    wp = -(-width // n) * n
    hp = -(-height // n) * n
    sub_c = 2 if chroma_format_idc == 1 else 1   # SubWidthC/SubHeightC
    if ((wp - width) % sub_c) or ((hp - height) % sub_c):
        raise ValueError(
            f"4:2:0 conformance window needs even crops: pad "
            f"{(wp - width, hp - height)} at block size {n}"
        )
    bw = _BW()
    bw.u(0, 4)                    # sps_video_parameter_set_id
    bw.u(0, 3)                    # sps_max_sub_layers_minus1
    bw.u(1, 1)                    # sps_temporal_id_nesting_flag
    _profile_tier_level(bw, chroma_format_idc, bit_depth)
    bw.ue(0)                      # sps_seq_parameter_set_id
    bw.ue(chroma_format_idc)      # chroma_format_idc
    bw.ue(wp)                     # pic_width_in_luma_samples
    bw.ue(hp)                     # pic_height_in_luma_samples
    if (wp, hp) != (width, height):
        bw.u(1, 1)                # conformance_window_flag (units of SubC)
        bw.ue(0)                  # left offset
        bw.ue((wp - width) // sub_c)   # right
        bw.ue(0)                  # top
        bw.ue((hp - height) // sub_c)  # bottom
    else:
        bw.u(0, 1)
    bw.ue(bit_depth - 8)          # bit_depth_luma_minus8
    bw.ue(bit_depth - 8)          # bit_depth_chroma_minus8
    bw.ue(4)                      # log2_max_pic_order_cnt_lsb_minus4
    bw.u(1, 1)                    # sps_sub_layer_ordering_info_present
    bw.ue(0)                      # sps_max_dec_pic_buffering_minus1[0]
    bw.ue(0)                      # sps_max_num_reorder_pics[0]
    bw.ue(0)                      # sps_max_latency_increase_plus1[0]
    bw.ue(lg2 - 3)                # log2_min_luma_coding_block_size_minus3
    bw.ue(1)                      # log2_diff_max_min_luma_coding_block
    bw.ue(lg2 - 2)                # log2_min_luma_transform_block_minus2
    bw.ue(0)                      # log2_diff_max_min_luma_transform
    bw.ue(0)                      # max_transform_hierarchy_depth_inter
    bw.ue(0)                      # max_transform_hierarchy_depth_intra
    bw.u(0, 1)                    # scaling_list_enabled_flag
    bw.u(0, 1)                    # amp_enabled_flag
    bw.u(0, 1)                    # sample_adaptive_offset_enabled_flag
    bw.u(0, 1)                    # pcm_enabled_flag
    bw.ue(0)                      # num_short_term_ref_pic_sets
    bw.u(0, 1)                    # long_term_ref_pics_present_flag
    bw.u(0, 1)                    # sps_temporal_mvp_enabled_flag
    bw.u(0, 1)                    # strong_intra_smoothing_enabled_flag
    bw.u(0, 1)                    # vui_parameters_present_flag
    bw.u(0, 1)                    # sps_extension_present_flag
    bw.rbsp_trailing()
    return bw.bytes()


def write_pps_hevc(cb_qp_offset: int = 0, cr_qp_offset: int = 0) -> bytes:
    """7.3.2.3.1 pic_parameter_set_rbsp, every optional tool off.

    cb/cr_qp_offset: for 4:2:0 exports, the offsets that steer the
    Table 8-10 chroma QP derivation back to the luma QP the framework
    quantized chroma with (chroma_qp_offset_for)."""
    if not (-12 <= cb_qp_offset <= 12 and -12 <= cr_qp_offset <= 12):
        raise ValueError("pps chroma QP offsets must be in [-12, 12]")
    bw = _BW()
    bw.ue(0)                      # pps_pic_parameter_set_id
    bw.ue(0)                      # pps_seq_parameter_set_id
    bw.u(0, 1)                    # dependent_slice_segments_enabled
    bw.u(0, 1)                    # output_flag_present_flag
    bw.u(0, 3)                    # num_extra_slice_header_bits
    bw.u(0, 1)                    # sign_data_hiding_enabled_flag
    bw.u(0, 1)                    # cabac_init_present_flag
    bw.ue(0)                      # num_ref_idx_l0_default_active_minus1
    bw.ue(0)                      # num_ref_idx_l1_default_active_minus1
    bw.se(0)                      # init_qp_minus26 (slice_qp_delta
                                  #   carries the real QP)
    bw.u(0, 1)                    # constrained_intra_pred_flag
    bw.u(0, 1)                    # transform_skip_enabled_flag
    bw.u(0, 1)                    # cu_qp_delta_enabled_flag
    bw.se(cb_qp_offset)           # pps_cb_qp_offset
    bw.se(cr_qp_offset)           # pps_cr_qp_offset
    bw.u(0, 1)                    # pps_slice_chroma_qp_offsets_present
    bw.u(0, 1)                    # weighted_pred_flag
    bw.u(0, 1)                    # weighted_bipred_flag
    bw.u(0, 1)                    # transquant_bypass_enabled_flag
    bw.u(0, 1)                    # tiles_enabled_flag
    bw.u(0, 1)                    # entropy_coding_sync_enabled_flag
    bw.u(0, 1)                    # pps_loop_filter_across_slices
    bw.u(1, 1)                    # deblocking_filter_control_present
    bw.u(0, 1)                    # deblocking_filter_override_enabled
    bw.u(1, 1)                    # pps_deblocking_filter_disabled_flag
    bw.u(0, 1)                    # pps_scaling_list_data_present_flag
    bw.u(0, 1)                    # lists_modification_present_flag
    bw.ue(0)                      # log2_parallel_merge_level_minus2
    bw.u(0, 1)                    # slice_segment_header_extension
    bw.u(0, 1)                    # pps_extension_present_flag
    bw.rbsp_trailing()
    return bw.bytes()


def export_hevc_stream(levels: np.ndarray, modes: np.ndarray,
                       height: int, width: int, n: int, qp: int,
                       bit_depth: int = 8) -> bytes:
    """One plane -> a standalone standard-syntax monochrome stream.

    levels (nb, N, N) raster layout, modes (nb,), CU raster order over
    the padded (ceil(h/N), ceil(w/N)) grid.  Returns the Annex B byte
    stream VPS+SPS+PPS+IDR slice.
    """
    w = HevcStreamWriter(height, width, n, qp, bit_depth=bit_depth,
                         chroma420=False)
    w.add_frame(levels, modes)
    return w.bytes()


def export_hevc_stream_420(levels_y: np.ndarray, modes_y: np.ndarray,
                           levels_cb: np.ndarray, levels_cr: np.ndarray,
                           modes_c: np.ndarray,
                           height: int, width: int, n: int, qp: int,
                           bit_depth: int = 8) -> bytes:
    """A full YUV frame -> a standalone standard-syntax 4:2:0 stream.

    levels_y (nb, N, N) raster; levels_cb/cr (nb, N/2, N/2) raster on
    the same CU grid; modes_c the shared per-CU chroma mode.  The PPS
    carries the cb/cr QP offsets that make the spec chroma-QP
    derivation equal the luma QP (chroma_qp_offset_for), matching how
    the framework quantizes chroma.
    """
    w = HevcStreamWriter(height, width, n, qp, bit_depth=bit_depth,
                         chroma420=True)
    w.add_frame(levels_y, modes_y, levels_cb, levels_cr, modes_c)
    return w.bytes()


class HevcStreamWriter:
    """Multi-frame standard-syntax Annex B stream builder.

    One VPS/SPS/PPS group up front, then one IDR_W_RADL access unit per
    add_frame() call — all-intra sequences are legal as consecutive IDR
    pictures (each resets the decoding chain; IDR slice headers carry
    no POC fields, 7.3.6.1).  Monochrome (chroma420=False) frames take
    (levels, modes); 4:2:0 frames take (levels_y, modes_y, levels_cb,
    levels_cr, modes_c).  The per-slice QP may vary per frame (rate
    control): it rides slice_qp_delta, but note CABAC contexts are
    re-initialized from each slice's own QP.
    """

    def __init__(self, height: int, width: int, n: int, qp: int, *,
                 bit_depth: int = 8, chroma420: bool = False):
        self.height, self.width, self.n = height, width, n
        self.qp = qp
        self.chroma420 = chroma420
        self.nby, self.nbx = -(-height // n), -(-width // n)
        cqo = chroma_qp_offset_for(qp) if chroma420 else 0
        self._chunks = [
            wrap_nal_hevc(NAL_VPS, write_vps_hevc()),
            wrap_nal_hevc(NAL_SPS, write_sps_hevc(
                width, height, n, bit_depth,
                chroma_format_idc=1 if chroma420 else 0,
            )),
            wrap_nal_hevc(NAL_PPS, write_pps_hevc(cqo, cqo)),
        ]
        self.frames = 0

    def add_frame(self, levels_y, modes_y, levels_cb=None, levels_cr=None,
                  modes_c=None, qp: int | None = None) -> None:
        from nanohevc_tpu_torch.runtime.hevc import (
            encode_slice_hevc,
            encode_slice_hevc_420,
        )

        fqp = self.qp if qp is None else qp
        if self.chroma420:
            if levels_cb is None or levels_cr is None or modes_c is None:
                raise ValueError("4:2:0 stream needs cb/cr levels and the "
                                 "shared chroma modes per frame")
            if fqp != self.qp and chroma_qp_offset_for(fqp) != (
                chroma_qp_offset_for(self.qp)
            ):
                raise ValueError(
                    f"per-frame QP {fqp} needs chroma offset "
                    f"{chroma_qp_offset_for(fqp)} but the stream PPS "
                    f"carries {chroma_qp_offset_for(self.qp)}"
                )
            rbsp = encode_slice_hevc_420(
                levels_y, modes_y, levels_cb, levels_cr, modes_c,
                self.nby, self.nbx, qp=fqp,
            )
        else:
            rbsp = encode_slice_hevc(levels_y, modes_y, self.nby, self.nbx,
                                     qp=fqp)
        self._chunks.append(wrap_nal_hevc(NAL_IDR_W_RADL, rbsp))
        self.frames += 1

    def bytes(self) -> bytes:
        return b"".join(self._chunks)
