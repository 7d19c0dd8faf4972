# Copy of nanohevc_tpu/config.py (only the import lines differ).
"""Encoder configuration (frozen, hashable -> usable as a jit static arg).

The reference passes block size / QP / DST flags as loose function
parameters (__main__.py:219-241, quant.py:45, transform.py:154); here
they are one immutable config object shared by the CLI, the encoder
pipelines and the benchmark harness.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EncoderConfig:
    """All-intra encoder settings.

    mode_set:
      "dc_planar"  - reference-parity decision (DC vs planar by residual
                     energy, __main__.py:165-179)
      "all"        - full 35-mode search (planar, DC, angular 2-34)
    decision:
      "energy" (SSE of prediction residual), "satd", "sad", or "rd"
      (true rate-distortion: SSE + lambda(QP) * bits per candidate
      mode through the real transform/quant/recon chain)
    """

    block_size: int = 8
    qp: int = 22
    bit_depth: int = 8
    is_intra: bool = True
    mode_set: str = "dc_planar"
    decision: str = "energy"
    # Mode set for the chroma planes; None inherits mode_set.  "dc" and
    # "planar" are fixed single-mode sets (no search).  The 4:2:0
    # standard-stream export needs chroma modes the spec can signal —
    # one shared intra_chroma_pred_mode per CU — which "dc"/"planar"
    # guarantee (always in the 8.4.3 candidate list or covered by DM).
    chroma_mode_set: str | None = None
    # Coefficient scan: "diag"/"horizontal"/"vertical" (spec 6.5.3
    # group orders applied uniformly) or "mode" (spec 7.4.9.11
    # mode-dependent selection at 4x4/8x8, diag above).
    scan: str = "diag"
    rdo_cbf: bool = False   # RD-optimized coded-block-flag decision
    # Rate-distortion optimized quantization (ops/rdoq.py): re-decide
    # quantized levels under D + lambda*R (level trim + last-position
    # choice against the calibrated coder rate model).  Encoder-only;
    # streams stay decodable.  The reference quantizer is plain
    # deadzone (its quant.py:41-79).
    rdoq: bool = False
    # Reference-sample smoothing (spec 8.4.4.2.3): [1 2 1] filter on
    # the prediction references for the modes the spec's filter-flag
    # rule selects (nothing at 4x4, DC never).  The reference
    # implementation has no smoothing; off keeps parity.
    intra_smoothing: bool = False
    # Spec-correct dequant size rescale.  The reference's dequantizer
    # omits the size-dependent term (its quant.py:110-121), attenuating
    # coded residuals 2^(log2 N - 2) at N > 4; True restores the
    # correct gain (better recon quality), False keeps bit parity.
    dequant_rescale: bool = False
    # Entropy engine for slice level payloads: "range" (framework
    # adaptive binary range coder, tiled/threaded), "cabac" (spec 9.3
    # arithmetic engine with 7.3.8.11 residual_coding syntax), or
    # "hevc-slice" (the full spec-syntax slice: 7.3.6.1
    # slice_segment_header + fixed-depth 7.3.8.4 coding_quadtree with
    # the 8.4.2.2 MPM intra-mode syntax coded in-CTU and the 7.4.9.11
    # mode-derived scanIdx — modes ride inside the slice, no separate
    # mode payload).
    entropy_coder: str = "range"
    # In-loop deblocking filter (spec 8.7.2, all-intra bS=2) applied
    # to the output reconstruction; intra prediction stays unfiltered
    # (spec semantics), so closed-loop decode remains pixel-exact.
    # Honored by the closed-loop pipeline; signalled in the PPS.
    deblock: bool = False
    # Sample Adaptive Offset (spec 8.7.3), after deblocking: one
    # encoder-estimated parameter set per plane per frame (EO/BO),
    # carried in a per-frame SAO NAL.  Output filter like deblock;
    # closed-loop pipeline only.
    sao: bool = False
    # CTB-granular SAO (the spec's real grain): per-tile parameters
    # RD-selected with merge-left/up flags (ops/sao_ctb.py), signalled
    # in a bit-packed CTB-SAO NAL.  Supersedes `sao` when set (the two
    # are mutually exclusive).  Closed-loop pipeline only.
    sao_ctb: bool = False
    sao_tile: int = 64      # CTB tile size in samples (power of two)

    def __post_init__(self):
        if self.block_size not in (4, 8, 16, 32):
            raise ValueError(f"block_size must be 4/8/16/32, got {self.block_size}")
        if self.mode_set not in ("dc_planar", "all", "dc", "planar"):
            raise ValueError(f"unknown mode_set: {self.mode_set}")
        if self.chroma_mode_set not in (None, "dc_planar", "all", "dc",
                                        "planar"):
            raise ValueError(
                f"unknown chroma_mode_set: {self.chroma_mode_set}"
            )
        if self.decision not in ("energy", "satd", "sad", "rd"):
            raise ValueError(f"unknown decision: {self.decision}")
        if self.scan not in ("diag", "horizontal", "vertical", "mode"):
            raise ValueError(f"unknown scan: {self.scan}")
        if self.entropy_coder not in ("range", "cabac", "hevc-slice"):
            raise ValueError(f"unknown entropy_coder: {self.entropy_coder}")
        if self.sao and self.sao_ctb:
            raise ValueError("sao and sao_ctb are mutually exclusive "
                             "(sao_ctb is the CTB-granular upgrade)")
        if self.sao_tile & (self.sao_tile - 1) or not (
            16 <= self.sao_tile <= 256
        ):
            raise ValueError(
                f"sao_tile must be a power of two in [16, 256], got "
                f"{self.sao_tile}"
            )

    def chroma_block_size(self) -> int:
        """U/V block size: half of luma, floor 4 (parity: __main__.py:156-158)."""
        return max(4, self.block_size // 2)

    def chroma_modes(self) -> str:
        """The mode set the chroma planes encode with."""
        return self.chroma_mode_set or self.mode_set

    def use_dst(self, n: int, is_luma: bool) -> bool:
        """DST-VII applies to 4x4 luma intra blocks only (HEVC rule)."""
        return self.is_intra and is_luma and n == 4
