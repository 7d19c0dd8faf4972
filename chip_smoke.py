"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main paths on seeded 1080p 4:2:0 input: the open-loop
all-intra encode and the closed-loop (wavefront) encode with its
decoder and its in-loop filters, each with the default EncoderConfig
(8x8 luma, 4x4 chroma, QP 22, DC/planar by energy) and with the
35-mode SATD search (mode_set="all", decision="satd", what the CLI's
--mode-search selects); the blocks API `fused_encode_planes`; and the sequence runner
over a 16-frame file at batch 8.  It checks them end to end:

1. the card, its power limit, and the PyTorch and CUDA versions;
2. builds the CUDA kernels from the sources in this checkout, one nvcc
   per source, all at once;
3. holds each kernel against its plain PyTorch version on the card,
   exactly: the slab kernel (3) and the mode-search kernel (3b) over
   N 4/8/16/32, DST at 4, 8/10-bit, both dequant modes and QP
   0/22/37/51, on a 1080x1920 luma and a 540x960 chroma plane, and at
   N 4/8 on a 45x200 plane that leaves thread blocks part empty (3b
   also on a 12-bit plane at N=32, where the packed (cost, mode) key
   does not fit int32); the wavefront kernel (3c), both bodies, over
   the same N, bit depths, dequant modes and QPs at batch 1 and 2 on a
   540x960 and a padded 45x200 plane, and at N 4 DST, 8 and 16 (padded
   to 1088 rows) on 1080x1920, then the row schedule's cases (a tall
   200x45 plane, one block row, one block column, the 16-plane chroma
   stack at N=4, a 12-bit search at N=32, and the 1080p search at N=8
   three more times, each equal to the first); what the wavefront
   kernel took over from JAX's closed-loop XLA scan (3g): the fixed
   modes dc and planar, DC/planar by SAD and SATD, the 35 modes by
   energy and SAD, and the two bodies above, each at N 4 DST, 4, 8, 16
   and 32 with luma smoothing off and on, RDOQ rotated over every scan
   and three lambda scales, 8/10/12-bit, both dequant modes and the four
   QPs on a 135x240 and a 45x200 crop, then the 1080p luma plane under
   RDOQ and with the smoothed search, three more times each, each equal
   to the first; the RD closed loop's kernel (3h), DC/planar and the 35
   modes at N 4 DST, 4, 8, 16 and 32 with smoothing off and on, RDOQ
   rotated over every scan and three lambda scales, 8/10/12-bit, both
   dequant modes and the four QPs on a 135x240 and a 45x200 crop at
   batch 1 and 2, and N 16 and 32 without RDOQ, then the 1080p luma
   plane at N=8 under both mode sets, 7d's RD batches (8 1080p luma
   planes at N=8, 16 540x960 chroma planes at N=4) and a batch of mixed
   texture, == the plain loop and three more times each == the first,
   then 32 1080p luma planes under the 35 modes, more than the grid
   holds at once (frames in turns), its first and last frame == the
   plain loop, and its
   prices against the host's over every pair of counts with n <= 4096
   and 10^7 seeded pairs up to 2^21, 0 bits differing; the fused blocks
   kernel
   (3e) over N 4-32, 8/10-bit and
   the four QPs on two 1080p planes and a 45x200 plane, and against the
   slab kernel (DCT, parity) on the 1080p plane's full block rows.  The
   row kernels (3: slab, 3e: fused) also meet the edges of their
   design: an adversarial 1080p plane (a 0 / max_pix checkerboard, and
   flat max_pix next to flat 0 across block edges) at 8, 10 and 12 bits,
   QP 0 and 51, every N (DST at 4 and both dequant modes for the slab
   kernel; 3e also against the slab kernel at 8 bits), and an input
   view 4 bytes past a 16-byte boundary, which must give the aligned
   input's outputs through a counted copy (`.copies`); the decode kernel
   (3f, run after 4d) over N 4 (DST), 8, 16, 32, smoothing off and on,
   8/10-bit, batches of 1 and 3 with a QP per frame, on a 128x256 and a
   138x250 crop of adversarial streams (random modes 0..34 and levels,
   decoded by `decode_planes` with no encoder, one launch a call), DC-only
   streams whose flat arms take the 32x32 strong filter, a batch of 8
   1080p luma planes at N=8 (a `decode_sequence` chunk) and a smoothed
   1080p plane at N=32, with block rows that W (the rows a thread block
   decodes together) does not divide at every N, and the luma plane of
   4d's 1080p search stream (three repeats, each == the first, and
   grids capped at 1 and 2 thread blocks, each == the plain version);
   the loop filters' three kernels (3i, run after 3f), each == its plain
   version with no tolerance: deblocking (luma and chroma, an int QP
   and a (B,) QP tensor of two values), the SAO estimate (its
   statistics and its parameters: per-plane SAO; CTB SAO at tiles 16,
   32, 64 and 128, merge on and off; two launches back to back and the
   replays of a captured CUDA graph, with no reset between them) and
   the application (the chosen parameters and seeded maps of every
   type), on the three padded 1080p planes of the default closed-loop
   recon, a 138x250 crop (unpadded: tails, partial tiles, a height no
   multiple of 4) at 8 and 10 bits, a 45x200 pair and a batch of 8
   540x960 planes;
4. encodes the frame on the card under each config through the open
   loop (4: default, 4b: mode search) and the closed loop (4c, 4d):
   the path's kernel must launch once per plane (3 times; the closed
   loop once for Y and once for U and V as one batch) and every other
   kernel not at all, the result must equal the port's plain
   path on the CPU, 256 sampled luma blocks must match the numpy
   oracle (for the closed loop, a per-block simulation on the
   reconstructed neighbours), and the bitstream written by the port's
   runtime must parse back to the same levels and modes; the closed
   loop's stream must decode on the card to the recon pixel for pixel,
   through the decode kernel: every decode gate (4c, 4d, 4g, 7c, 8a-8c,
   9d) runs with the counts at 0 and must launch `decode_blocks` once a
   `decode_planes` call (3 a frame, 3 a `decode_sequence` chunk of 8) and
   no other kernel.
   4e: `fused_encode_planes` on 8 luma planes in one launch, equal to
   the plain path on the CPU over a 270x480 crop and to the oracle.
   4f/4g: `encode_sequence` on 16 frames, open and closed loop, under
   both configs: 3 x 16 launches of K1 (K2), or 2 a batch of the
   wavefront kernel, and none of any other; every frame parses back to
   its single-frame encode on the card; a 4-frame 270x480 sequence
   gives the CPU's bytes; `decode_sequence` on the card gives the
   closed loop's recon.  4h: target_bpp rate control (open and closed
   loop), resume (8 frames, then 16 == a straight run), a corrupt
   sidecar (restart from frame 0).  4i: the closed-loop configs no
   other phase runs (luma smoothing, the horizontal, vertical and mode
   scans, the dequant rescale, chroma mode sets, DC/planar by SAD and
   SATD, the 35 modes by energy and SAD, RDOQ under the mode scan) on a
   256x256 and a 138x250 crop and the default config at 10 bits on the
   1080p frame: 2 wavefront launches a frame, no other kernel, no
   plain-loop entry, card == CPU in recon and bytes, each stream decoded
   on the card to its recon;
5. runs the CLI under each config and compares its bitstream (5, 5b:
   open loop; 5c: closed loop, then `decode`; 5d: `encode-seq` open,
   closed and `--target-bpp`, `decode` of the sequence, `encode
   --target-bytes` against `find_frame_qp`);
6. times kernels and plain versions per 1080p luma plane (6, 6b, 6c:
   with the grids each call launched, and one launch on 8 luma planes
   and on the 16-plane chroma stack; 6e: also a batch of 8 for the
   fused kernel; K1, K2 and K5 on the card through a CUDA graph of their
   calls, since their wrappers cost the host more than the kernels
   take, and in a launch loop beside it), the frame under each
   config, the closed-loop frame and its decode (6c), the decode kernel
   per 1080p luma plane at N 4-32 through a CUDA graph with its bound
   and us a block on the chain, `decode_residual` (the plain PyTorch
   step before it) beside it (6d; the plain version at N=8 only) and
   `decode_frame`'s split (host parse, device busy share), each row of
   what the kernel took over from the XLA scan per 1080p luma plane at
   N=8 through a CUDA graph beside the plain loop and its bound (6g),
   the RD kernel per 1080p luma plane at every N under both mode sets
   through a CUDA graph, at N=8 and on 7d's two batches beside its
   synchronisation alone on the same grid, its bound and the plain loop
   (6h), each loop-filter kernel and its plain version a padded 1080p
   plane (Y, U, V) through a CUDA graph beside its bound (6i), and the
   sequence
   under all four configs (6f: throughput, stages, whether drain
   overlaps the next batch, device busy share, entropy_tiles=4,
   `decode_sequence`);
7. runs the RD stages: the open loop's plain PyTorch on the card as
   the JAX package runs them on its XLA path (no kernel launch); the
   closed loop's RDOQ in the wavefront kernel and its decision="rd" in
   the RD kernel (one launch an encode_planes_closed_loop call, no
   plain-loop entry): 7a the 1080p frame under rdo_cbf+rdoq (default
   and mode search) and decision="rd", each equal to the port on the
   CPU (recon, levels, modes, nnz, bytes), with its frame call and
   device part; 7b the 35-mode RD decision (open loop) and the closed
   loop with RDOQ, with decision="rd" (DC/planar, the 35 modes with
   smoothing and RDOQ, a fixed chroma mode set on the wavefront
   kernel's fixed body) on a 256x256 and a 138x250 crop, card == CPU,
   each closed-loop stream decoded on the card to its recon; 7c both
   closed-loop RD encodes at 1080p, == the CPU, frame call first and
   warm, decoded on the card pixel for pixel; 7d 16-frame sequences at
   batch 8 with rdo_cbf+rdoq (open loop), rdoq and decision="rd"
   (closed loop), every frame equal to its single-frame encode, bytes
   and mean Y-PSNR beside the runs without RD; 7e the CLI's `encode
   --rdo --rdoq` and `encode --decision rd`, bytes equal to the API's;
8. runs the in-loop filters on their kernels (deblocking, then the SAO
   estimate and application: three launches a plane batch in the
   encoder where deblocking and SAO are both on, two in the decoders,
   checked with the counts at 0
   on every filtered encode and decode, with no plain filter on the
   card) after the wavefront kernel: 8a the closed loop with deblock, sao, sao_ctb
   (tiles of 32 and 64), deblock+sao and deblock+sao_ctb under the
   default config and the mode search, and deblock+sao_ctb at 10 bits,
   on a 256x256 and a 138x250 crop, and deblock+sao_ctb with RDOQ and
   with decision="rd" (the RD kernel once a plane batch, no plain-loop
   entry) on the 138x250 crop: card == CPU in recon and
   bytes, each stream decoded on the card to its recon; 8b the 1080p frame with deblock+sao and deblock+sao_ctb
   under both configs: the wavefront kernel and each filter kernel
   launch once a plane batch (Y, then U and V) and nothing else
   launches, the stream decodes on
   the card to the recon, bytes and Y-PSNR beside the unfiltered encode,
   the frame call and its device part, and each filter stage's time a
   plane, kernels beside the plain ops; 8c 16-frame
   sequences at batch 8 with deblock+sao_ctb and with deblock+sao under
   target_bpp: each frame == its single-frame encode at its slice QP
   (levels, modes, SAO parameters), decode_sequence on the card == the
   recon; 8d, in one CLI process, `encode --pipeline closed-loop
   --deblock --sao-ctb` and `decode` (the API's bytes and recon), and
   `--hevc-export` (4:2:0, `--hevc-mono`, `encode-seq`) on a crop, the
   card's streams == the CPU's;
9. runs the multi-device encoders (`parallel`) on a mesh over every
   visible card when there are two or more, else on a logical (2, 2)
   (frame, space) mesh on the one card, whose shards run one after
   another: 9a the open loop on a 4-frame 1080p luma batch under the
   default config and the mode search, K1 (K2) launching frames x space
   times on the row shards, and at block size 16 (1080 rows are no
   whole number of block-rows) K1 once a plane on the frame shards,
   each equal bit for bit to the mesh-less encoder on the card, with
   both calls' times, and
   `sample_parity_check` on the first frame; 9b the frame-sharded
   closed loop (default, mode search, deblock+sao_ctb), one wavefront
   launch a frame shard, equal to the mesh-less encoder; 9c 4-frame
   138x250 and 136x248 crops, card mesh == a same-shape mesh of "cpu"
   entries; 9d `encode_sequence` of 8 frames at batch 4 under the mesh,
   open and closed loop, bytes equal to the mesh-less run, the closed
   loop's stream decoded on the card to its recon.

Prints one JSON line of kernel results before the last line (the
wavefront kernel has an entry per body, each with its launches, and one
for each row of what it took over from JAX's XLA scan, SCAN_ROWS, whose
launches are 4i's and 7b-7d's; the RD kernel has an entry per mode
set, whose launches are 7b-7d's and 8a's; the
decode kernel's entry counts the decode gates' launches; the four
loop-filter kernels', timed on the 1080p luma plane, count 8a-8c's and
9b's), and
as the last line {"ok": true, "device": {...}}.  Exits non-zero, without that
line, when there is no CUDA card or a phase fails.

Each kernel's bound in the JSON line is the larger of its bytes over
the card's 3.35 TB/s and its integer operations over 67 T/s (the H100
SXM's float32 rate outside the tensor cores, which no int32 add or
multiply exceeds), counted per pixel as `kernel_bound` (`fused_bound`
for the fused blocks kernel, `decode_bound` for the decode kernel,
`scan_bound` for the XLA scan's rows, RDOQ's float32 operations at the
same rate, `rd_bound` for the RD kernel, `filter_bound` for the loop
filters) says.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

try:
    import torch

    from nanohevc_tpu_torch import ops
    from nanohevc_tpu_torch import ref as oracle
    from nanohevc_tpu_torch.cli import assemble_frame_bitstream
    from nanohevc_tpu_torch.config import EncoderConfig
    from nanohevc_tpu_torch.frame import Frame, Plane
    from nanohevc_tpu_torch.kernels import build
    from nanohevc_tpu_torch.kernels import wavefront as kwf
    from nanohevc_tpu_torch.kernels.decode import (
        decode_blocks,
        decode_blocks_reference,
        group_rows,
    )
    from nanohevc_tpu_torch.kernels.fused_pipeline import (
        fused_encode_blocks,
        fused_encode_blocks_reference,
        fused_encode_planes,
        fused_encode_planes_reference,
    )
    from nanohevc_tpu_torch.kernels.mode_search import (
        mode_search_encode_plane,
        mode_search_encode_plane_reference,
    )
    from nanohevc_tpu_torch.kernels.slab_pipeline import (
        slab_encode_plane,
        slab_encode_plane_reference,
    )
    from nanohevc_tpu_torch.kernels.wavefront import (
        wavefront_encode_planes,
        wavefront_encode_planes_reference,
    )
    from nanohevc_tpu_torch.kernels import loop_filter as lf
    from nanohevc_tpu_torch.kernels import wavefront_rd as krd
    from nanohevc_tpu_torch.ops import rate
    from nanohevc_tpu_torch.ops import sao as ops_sao
    from nanohevc_tpu_torch.ops import sao_ctb as ops_ctb
    from nanohevc_tpu_torch.models import sequence as seq
    from nanohevc_tpu_torch.models import wavefront as torch_wf
    from nanohevc_tpu_torch.models.all_intra import (
        encode_frame_full,
        encode_plane_config,
    )
    from nanohevc_tpu_torch.models.rate_control import find_frame_qp
    from nanohevc_tpu_torch.models.wavefront import (
        decode_frame,
        decode_planes,
        decode_residual,
        encode_frame_closed_loop,
        encode_planes_closed_loop,
        pad_to_blocks,
        plane_args,
    )
    from nanohevc_tpu_torch.ops.intra import mode_filter_flags
    from nanohevc_tpu_torch.parallel import (
        make_batch_encoder,
        make_closed_loop_encoder,
        make_mesh,
    )
    from nanohevc_tpu_torch.ref.metrics import hadamard_matrix
    from nanohevc_tpu_torch.ref.metrics import ssim as ssim_host
    from nanohevc_tpu_torch.runtime import assemble_bitstream, parse_bitstream
    from nanohevc_tpu_torch.utils import sample_parity_check
except ImportError as exc:
    print(f"chip_smoke: cannot import the port ({exc}); run it from the "
          "root of a checkout of the repository", file=sys.stderr)
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 1080, 1920
SEED = 0
MODE_SEARCH = EncoderConfig(mode_set="all", decision="satd")


def rd_plain(planes, qp, n, *, mode_set="dc_planar", bit_depth=8,
             use_dst=False, dequant_rescale=False, intra_smoothing=False,
             rdoq=False, scan="diag", rd_lambda_scale=1.0):
    """The RD kernel's plain version,
    `kernels.wavefront_rd.wavefront_rd_encode_planes_reference` (looked
    up by name at the call), with the wrapper's keywords."""
    return krd.wavefront_rd_encode_planes_reference(
        planes, qp, n, mode_set=mode_set, use_dst=use_dst,
        bit_depth=bit_depth, scan=scan, dequant_rescale=dequant_rescale,
        intra_smoothing=intra_smoothing, rdoq=rdoq,
        rd_lambda_scale=rd_lambda_scale)


# (kernel wrapper, plain version, source, TPU kernel(s) it replaces)
KERNELS = {
    "slab_encode_plane": (
        slab_encode_plane, slab_encode_plane_reference,
        "nanohevc_tpu_torch/csrc/slab_pipeline.cu",
        "nanohevc_tpu/kernels/slab_pipeline.py:275",
    ),
    "mode_search_encode_plane": (
        mode_search_encode_plane, mode_search_encode_plane_reference,
        "nanohevc_tpu_torch/csrc/mode_search.cu",
        "nanohevc_tpu/kernels/mode_search_slab.py:457, "
        "nanohevc_tpu/kernels/mode_search_grouped.py:426",
    ),
    "wavefront_encode_planes": (
        wavefront_encode_planes, wavefront_encode_planes_reference,
        "nanohevc_tpu_torch/csrc/wavefront.cu",
        "nanohevc_tpu/kernels/wavefront_mode_grouped.py:199, "
        "nanohevc_tpu/kernels/wavefront_mode_slab.py:182, "
        "nanohevc_tpu/kernels/wavefront_slab.py:151, "
        "nanohevc_tpu/models/wavefront.py:414 (XLA scan)",
    ),
    "fused_encode_blocks": (
        fused_encode_blocks, fused_encode_blocks_reference,
        "nanohevc_tpu_torch/csrc/fused_pipeline.cu",
        "nanohevc_tpu/kernels/fused_pipeline.py:136",
    ),
    "wavefront_rd_encode_planes": (
        krd.wavefront_rd_encode_planes, rd_plain,
        "nanohevc_tpu_torch/csrc/wavefront_rd.cu",
        "nanohevc_tpu/models/wavefront.py:368 (the decision=\"rd\" branch "
        "of encode_planes_closed_loop's jax.lax.scan, vmapped over frames "
        "at :421; an XLA scan, no Pallas kernel)",
    ),
    "decode_blocks": (
        decode_blocks, decode_blocks_reference,
        "nanohevc_tpu_torch/csrc/decode.cu",
        "nanohevc_tpu/models/wavefront.py:779 (decode_plane's jax.lax.scan, "
        "an XLA scan; no Pallas kernel)",
    ),
}
# The wavefront kernel's two bodies, by (mode_set, decision).
WAVEFRONT_BODIES = {"dc_planar": ("dc_planar", "energy"),
                    "search": ("all", "satd")}
# What the wavefront kernel codes as the counterpart of JAX's closed-loop
# XLA scan: every (mode_set, decision) but decision="rd", smoothing and
# RDOQ on each (3g), by the name 3g gives the body.
SCAN_BODIES = {"dc": ("dc", "energy"), "planar": ("planar", "energy"),
               "pair sad": ("dc_planar", "sad"),
               "pair satd": ("dc_planar", "satd"),
               "all energy": ("all", "energy"), "all sad": ("all", "sad"),
               **WAVEFRONT_BODIES}
XLA_SCAN = ("nanohevc_tpu/models/wavefront.py:414 (encode_planes_closed_loop"
            "'s jax.lax.scan, an XLA scan; no Pallas kernel)")
# The kernels-line rows of what the kernel took over from the XLA scan:
# row -> (label, the 1080p luma plane's keywords at N = 8 for 6g).  The
# two switches' rows count their launches under every body, and are
# timed on the body their label names.
SCAN_ROWS = {
    "fixed": ("wavefront_encode_planes (fixed-mode body)",
              dict(mode_set="dc", decision="energy")),
    "pair": ("wavefront_encode_planes (DC/planar body by SAD or SATD)",
             dict(mode_set="dc_planar", decision="satd")),
    "sweep": ("wavefront_encode_planes (35-mode body by energy or SAD)",
              dict(mode_set="all", decision="sad")),
    "smoothing": ("wavefront_encode_planes (luma smoothing switch, any body; "
                  "timed on the search body)",
                  dict(mode_set="all", decision="satd", intra_smoothing=True)),
    "rdoq": ("wavefront_encode_planes (RDOQ tail switch, any body; timed "
             "on the DC/planar body)",
             dict(mode_set="dc_planar", decision="energy", rdoq=True)),
}
# Main-path launches of each row (4i, 7b-7d), from the wrapper's
# launches_by_config.
SCAN_LAUNCHES = dict.fromkeys(SCAN_ROWS, 0)
# The RD closed loop's kernel: its kernels-line rows by mode set, and
# their main-path launches (7b-7d, 8a), from the wrapper's
# launches_by_config.
RD_SETS = {"dc_planar": "wavefront_rd_encode_planes",
           "all": "wavefront_rd_encode_planes (35 modes)"}
RD_LAUNCHES = dict.fromkeys(RD_SETS, 0)


def log(*args):
    print(*args, flush=True)


def textured(h: int, w: int, bit_depth: int, rng) -> np.ndarray:
    """Seeded plane with smooth ramps, flat patches, edges and noise, so
    both modes win and every quantizer branch sees nonzero levels."""
    peak = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = (yy * (peak + 1) // max(h, 1) + xx * (peak + 1) // (2 * max(w, 1)))
    wave = (peak // 8) * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    base = (ramp + wave).astype(np.int64)
    flat = rng.integers(0, 4, (h // 64 + 1, w // 64 + 1)) == 0
    base = np.where(flat[yy // 64, xx // 64], peak // 2, base)
    noise = rng.integers(-peak // 16, peak // 16 + 1, (h, w))
    return np.clip(base + noise, 0, peak).astype(np.int32)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def captured(fn, iters: int):
    """A CUDA graph of `iters` fn() calls, captured after a warm-up on a
    side stream (the first call builds and uploads the kernel's
    tables)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return graph


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call with the host's launch cost taken
    out: `iters` calls in one CUDA graph, each of `replays` replays timed
    between CUDA events; the median replay over `iters`.  A wrapper that
    costs the host more than its kernel takes on the card reads as host
    time under cuda_ms."""
    graph = captured(fn, iters)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[replays // 2]


def cold_l2_ms(fn, dev, iters: int = 10) -> float:
    """Mean device time of one fn() call, captured in a CUDA graph, with
    the 50 MB L2 overwritten before each replay (a 256 MB memset), so
    its inputs come from HBM."""
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    graph = captured(fn, 1)
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def max_abs_err(got: dict, want: dict) -> int:
    return max(
        int((got[k].long() - want[k].long()).abs().max()) if want[k].numel() else 0
        for k in want
    )


def reset_launches() -> None:
    for name in KERNELS:
        KERNELS[name][0].launches = 0
    for name in FILTER_KERNELS:
        FILTER_KERNELS[name][0].launches = 0
    wavefront_encode_planes.launches_by_config.clear()
    krd.wavefront_rd_encode_planes.launches_by_config.clear()


def scan_row(mode_set: str, decision: str, smoothing: bool, rdoq: bool):
    """The kernels-line row of a wavefront launch's configuration: one
    of SCAN_ROWS, or None for the two bodies of the TPU kernels."""
    if rdoq:
        return "rdoq"
    if smoothing:
        return "smoothing"
    if mode_set in ("dc", "planar"):
        return "fixed"
    if (mode_set, decision) in WAVEFRONT_BODIES.values():
        return None
    return "pair" if mode_set == "dc_planar" else "sweep"


def add_scan_launches() -> dict:
    """Add the wrapper's launches since the last reset to SCAN_LAUNCHES,
    by row; returns {row: launches} of this run."""
    got = {}
    for key, count in wavefront_encode_planes.launches_by_config.items():
        row = scan_row(*key)
        if row is not None:
            got[row] = got.get(row, 0) + count
            SCAN_LAUNCHES[row] += count
    return got


class PlainLoopEntries:
    """Counts the closed loop's plain entries while it is open: the
    plain loop (`wavefront_encode_planes_reference`, which the wrapper
    reaches for a CPU tensor) and the RD decision's slot batches
    (`kernels.wavefront_rd.wavefront_rd_encode_planes_reference`), each
    looked up by name where it is called."""

    def __enter__(self):
        self.count = 0
        self.saved = (kwf.wavefront_encode_planes_reference,
                      krd.wavefront_rd_encode_planes_reference)

        def counted(fn):
            def call(*args, **kwargs):
                self.count += 1
                return fn(*args, **kwargs)
            return call

        kwf.wavefront_encode_planes_reference = counted(self.saved[0])
        krd.wavefront_rd_encode_planes_reference = counted(self.saved[1])
        return self

    def __exit__(self, *exc):
        (kwf.wavefront_encode_planes_reference,
         krd.wavefront_rd_encode_planes_reference) = self.saved
        return False


# Plane batches of one encode_frame_closed_loop call: Y, then U and V as
# one batch; each launches its kernel once.
FRAME_BATCHES = 2


def read_launches() -> dict:
    return {name: KERNELS[name][0].launches for name in KERNELS}


def phase_kernel_vs_plain(dev, name: str, tag: str,
                          wide_bits: bool = False) -> int:
    """The kernel == its plain version over N 4 (DCT and DST) to 32,
    8/10-bit, both dequant modes and four QPs on three planes; with
    `wide_bits`, also a 12-bit plane at N=32, where the search's packed
    (cost, mode) key does not fit int32."""
    kernel, plain = KERNELS[name][:2]
    rng = np.random.default_rng(SEED)
    worst = 0
    cases = 0
    sizes = ((4, False), (4, True), (8, False), (16, False), (32, False))
    # The 45x200 plane leaves the last thread block of N=4 and N=8 part
    # empty (its block count is no multiple of 16 or 4).
    grid = [(shape, bd, sizes, (0, 22, 37, 51))
            for shape in ((H, W), (H // 2, W // 2), (45, 200))
            for bd in (8, 10)]
    if wide_bits:
        grid.append(((H // 2, W // 2), 12, ((32, False),), (22, 37)))
    for shape, bit_depth, n_list, qps in grid:
        plane = torch.from_numpy(textured(*shape, bit_depth, rng)).to(dev)
        for n, use_dst in n_list:
            if shape[1] % n:
                continue
            for rescale in (False, True):
                for qp in qps:
                    kw = dict(bit_depth=bit_depth, use_dst=use_dst,
                              dequant_rescale=rescale)
                    got = kernel(plane, qp, n, **kw)
                    want = plain(plane, qp, n, **kw)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    if err:
                        raise SystemExit(
                            f"{name} != plain at {shape} N={n} "
                            f"dst={use_dst} bd={bit_depth} "
                            f"rescale={rescale} qp={qp}: max abs err {err}")
                    worst = max(worst, err)
                    cases += 1
    log(f"[{tag}] {name} == plain on CUDA in {cases} cases "
        f"{'(4 of them 12-bit at N=32) ' if wide_bits else ''}"
        f"(max abs err {worst})")
    return worst


def edge_plane(h: int, w: int, bit_depth: int, n: int) -> np.ndarray:
    """The adversarial plane: a 0 / max_pix checkerboard in the top
    half, and flat max_pix next to flat 0 in alternate N x N blocks in
    the bottom half, so that every block edge there is a full step."""
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (yy + xx) % 2 == 0
    blocks = (yy // n + xx // n) % 2 == 0
    hot = np.where(yy < h // 2, checker, blocks)
    return np.where(hot, (1 << bit_depth) - 1, 0).astype(np.int32)


def misaligned(t):
    """A contiguous view of t's values whose data pointer is 4 bytes
    past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 != 4:
        raise SystemExit("could not make a view 4 bytes past a 16-byte "
                         "boundary")
    return view


def phase_slab_edges(dev) -> int:
    """3: K1 == its plain version on the adversarial 1080p plane at 8,
    10 and 12 bits, QP 0 and 51, every N (DST at 4), both dequant
    modes; then a plane view 4 bytes past a 16-byte boundary == the
    aligned plane, through one counted copy a call."""
    worst, cases = 0, 0
    sizes = ((4, False), (4, True), (8, False), (16, False), (32, False))
    for bd in (8, 10, 12):
        for n, use_dst in sizes:
            plane = torch.from_numpy(edge_plane(H, W, bd, n)).to(dev)
            for qp in (0, 51):
                for rescale in (False, True):
                    kw = dict(bit_depth=bd, use_dst=use_dst,
                              dequant_rescale=rescale)
                    got = slab_encode_plane(plane, qp, n, **kw)
                    want = slab_encode_plane_reference(plane, qp, n, **kw)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    if err:
                        raise SystemExit(
                            f"slab_encode_plane != plain on the adversarial "
                            f"plane at N={n} dst={use_dst} bd={bd} qp={qp} "
                            f"rescale={rescale}: max abs err {err}")
                    cases += 1
    plane = torch.from_numpy(textured(H, W, 8, np.random.default_rng(SEED + 4))).to(dev)
    copies = slab_encode_plane.copies
    for n, use_dst in sizes:
        got = slab_encode_plane(misaligned(plane), 22, n, use_dst=use_dst)
        want = slab_encode_plane(plane, 22, n, use_dst=use_dst)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, want))
    if worst or slab_encode_plane.copies != copies + len(sizes):
        raise SystemExit(f"slab_encode_plane on a misaligned view: max abs "
                         f"err {worst}, copies {slab_encode_plane.copies - copies} "
                         f"(expected {len(sizes)})")
    log(f"[3] slab_encode_plane == plain on CUDA in {cases} adversarial cases "
        f"(8/10/12-bit, QP 0/51); a misaligned plane view == the aligned "
        f"plane in {len(sizes)} cases, one counted copy each")
    return worst


def make_frame(rng) -> Frame:
    return Frame(Plane(textured(H, W, 8, rng).astype(np.int16)),
                 Plane(textured(H // 2, W // 2, 8, rng).astype(np.int16)),
                 Plane(textured(H // 2, W // 2, 8, rng).astype(np.int16)))


def oracle_refs(plane: np.ndarray, y0: int, x0: int, n: int):
    """Top and left arms (2N+1, corner at 0) with extract_refs' rules:
    columns clamped to W-1, rows clamped to H-1, 128 outside the plane."""
    h, w = plane.shape
    cols = np.minimum(x0 + np.arange(2 * n), w - 1)
    rows = np.minimum(y0 + np.arange(2 * n), h - 1)
    corner = 128 if y0 == 0 or x0 == 0 else int(plane[y0 - 1, x0 - 1])
    top = np.full(2 * n + 1, 128, np.int32)
    left = np.full(2 * n + 1, 128, np.int32)
    top[0] = left[0] = corner
    if y0 > 0:
        top[1:] = plane[y0 - 1, cols]
    if x0 > 0:
        left[1:] = plane[rows, x0 - 1]
    return top, left


def oracle_search(blk: np.ndarray, top: np.ndarray, left: np.ndarray,
                  n: int) -> np.ndarray:
    """The 35-mode SATD decision with the numpy oracle's predictors:
    costs over [planar, DC, 2..34], ties to the lowest index."""
    had = hadamard_matrix(n).astype(np.int64)
    t, lf = top[1:n + 1], left[1:n + 1]
    best, best_pred = None, None
    for mode in range(35):
        if mode == 0:
            pred = oracle.intra_planar_predict(t, lf, int(top[n]), int(left[n]), n)
        elif mode == 1:
            pred = oracle.intra_dc_predict(t, lf, n)
        else:
            pred = oracle.intra_angular_predict(top, left, int(top[0]), mode, n)
        d = blk.astype(np.int64) - pred.astype(np.int64)
        cost = int(np.abs(had @ d @ had.T).sum())
        if best is None or cost < best:
            best, best_pred = cost, pred
    return best_pred


def closed_loop_refs(recon: np.ndarray, y0: int, x0: int, n: int):
    """Top and left arms (2N+1, corner at 0) under the closed loop's
    availability rule, from the finished reconstruction: 128 on the
    plane's top row and left column (and the corner there); the
    extensions past N are 0 (same diagonal, not yet reconstructed)
    except at the last block-column (block-row), which replicates T[N]
    (L[N])."""
    h, w = recon.shape
    top = np.full(2 * n + 1, 128, np.int32)
    left = np.full(2 * n + 1, 128, np.int32)
    corner = 128 if y0 == 0 or x0 == 0 else int(recon[y0 - 1, x0 - 1])
    if y0 > 0:
        top[0] = corner
        top[1:n + 1] = recon[y0 - 1, x0:x0 + n]
        top[n + 1:] = top[n] if x0 + n == w else 0
    if x0 > 0:
        left[0] = corner
        left[1:n + 1] = recon[y0:y0 + n, x0 - 1]
        left[n + 1:] = left[n] if y0 + n == h else 0
    return top, left


def oracle_gate(plane: np.ndarray, levels: np.ndarray, recon: np.ndarray,
                n: int, qp: int, search: bool = False,
                closed: bool = False) -> int:
    """Count of 256 sampled blocks that differ from the numpy oracle
    (levels (nb, N, N) raster blocks, recon (H, W)); `search` picks the
    35-mode SATD decision instead of DC/planar by energy.  `closed`
    takes each block's references from `recon` under the closed loop's
    rule, so each sampled block is a step of the sequential per-block
    simulation, on the neighbours the encoder reconstructed."""
    rng = np.random.default_rng(SEED)
    nbx = plane.shape[1] // n
    nb = (plane.shape[0] // n) * nbx
    bad = 0
    for b in rng.choice(nb, size=min(256, nb), replace=False):
        y0, x0 = (b // nbx) * n, (b % nbx) * n
        blk = plane[y0:y0 + n, x0:x0 + n]
        top, left = (closed_loop_refs(recon, y0, x0, n) if closed
                     else oracle_refs(plane, y0, x0, n))
        if search:
            pred = oracle_search(blk, top, left, n)
        else:
            t, lf = top[1:n + 1], left[1:n + 1]
            dc = oracle.intra_dc_predict(t, lf, n)
            pln = oracle.intra_planar_predict(t, lf, int(top[n]), int(left[n]), n)
            e_dc = oracle.residual_energy(oracle.residual_block(blk, dc))
            e_pl = oracle.residual_energy(oracle.residual_block(blk, pln))
            pred = dc if e_dc <= e_pl else pln
        res = blk.astype(np.int32) - pred.astype(np.int32)
        lvl = oracle.quantize(oracle.forward_transform(res), qp, n)
        inv = oracle.inverse_transform(oracle.dequantize(lvl, qp, n))
        want = np.clip(pred.astype(np.int32) + inv, 0, 255)
        if not (np.array_equal(lvl, levels[b])
                and np.array_equal(want, recon[y0:y0 + n, x0:x0 + n])):
            bad += 1
    return bad


def same_encode(a, b) -> bool:
    (ra, ia), (rb, ib) = a, b
    if not all(np.array_equal(getattr(ra, p).data, getattr(rb, p).data)
               for p in "yuv"):
        return False
    for name in "YUV":
        pa, pb = ia["planes"][name], ib["planes"][name]
        if pa["nnz"] != pb["nnz"] or pa["block_size"] != pb["block_size"]:
            return False
        for k in ("levels", "modes"):
            if pa[k].dtype != pb[k].dtype or not np.array_equal(pa[k], pb[k]):
                return False
    return ia["blocks"] == ib["blocks"]


def phase_main_path(dev, frame: Frame, config: EncoderConfig, path: str,
                    tag: str):
    """Encode the frame on the card through `path` (a KERNELS name):
    that kernel must launch 3 times and every other kernel 0 times."""
    reset_launches()
    t0 = time.perf_counter()
    recon, info = encode_frame_full(frame, config, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[{tag}] encode_frame_full on {dev}: {first_s:.3f} s (first call), "
        f"kernel launches {launches}")
    want = {name: 3 if name == path else 0 for name in KERNELS}
    if launches != want:
        raise SystemExit(f"main path launched {launches}, expected {want} "
                         "(Y, U, V through one kernel)")

    t0 = time.perf_counter()
    cpu = encode_frame_full(frame, config, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not same_encode((recon, info), cpu):
        raise SystemExit("CUDA encode differs from the plain path on the CPU")
    log(f"[{tag}] CUDA encode == plain path on the CPU (recon, levels, modes, "
        f"nnz; plain path {cpu_s:.2f} s)")

    y = torch.from_numpy(frame.y.data.astype(np.int32)).to(dev)
    out = KERNELS[path][0](y, config.qp, config.block_size)
    bad = oracle_gate(frame.y.data, out["levels"].cpu().numpy(),
                      out["recon"].cpu().numpy(), config.block_size, config.qp,
                      search=config.mode_set == "all")
    if bad:
        raise SystemExit(f"{bad} of 256 sampled blocks differ from the oracle")
    log(f"[{tag}] 256 sampled luma blocks == numpy oracle")

    for name in "YUV":
        p = info["planes"][name]
        if p["levels"].dtype != np.int32 or p["modes"].dtype != np.int32:
            raise SystemExit(f"plane {name}: outputs are not int32")
    rec_y = recon.y.data
    if rec_y.shape != (H, W) or rec_y.min() < 0 or rec_y.max() > 255:
        raise SystemExit("luma recon has the wrong shape or range")
    bits = assemble_frame_bitstream(W, H, config, info)
    parsed = parse_bitstream(bits)
    for name in "YUV":
        p = info["planes"][name]
        if not (np.array_equal(parsed[name]["levels"], p["levels"])
                and np.array_equal(parsed[name]["modes"], p["modes"])):
            raise SystemExit(f"bitstream does not parse back for plane {name}")
    modes_y = np.bincount(info["planes"]["Y"]["modes"], minlength=35)
    log(f"[{tag}] bitstream {len(bits)} bytes parses back to the same levels "
        f"and modes; Y-PSNR {info['psnr_y']:.2f} dB, SSIM "
        f"{info['ssim_y']:.4f}; luma modes used {int((modes_y > 0).sum())} "
        f"of 35")
    return launches[path], bits


def phase_cli(frame: Frame, bits: bytes, extra: list, tag: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "frame.yuv")
        out = os.path.join(tmp, "out.bin")
        with open(src, "wb") as f:
            f.write(frame.to_yuv420p())
        proc = subprocess.run(
            [sys.executable, "-m", "nanohevc_tpu_torch", "encode", src,
             "--width", str(W), "--height", str(H), "--pipeline", "full",
             "--bitstream", out, *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise SystemExit(f"CLI failed (rc {proc.returncode}):\n{proc.stderr}")
        with open(out, "rb") as f:
            cli_bits = f.read()
    if cli_bits != bits:
        raise SystemExit("CLI bitstream differs from the library encode")
    log(f"[{tag}] CLI encode {' '.join(extra)} on the GPU: rc 0, bitstream "
        f"identical ({len(bits)} bytes)")


def kernel_times(dev, name: str, tag: str, gpu: str) -> dict:
    """Kernel and plain version per seeded 1080p luma plane, N 4 (DST)
    to 32, QP 22, CUDA events."""
    kernel, plain = KERNELS[name][:2]
    rng = np.random.default_rng(SEED + 1)
    y = torch.from_numpy(textured(H, W, 8, rng)).to(dev)
    mpix = H * W / 1e6
    times = {}
    for n in (4, 8, 16, 32):
        use_dst = n == 4
        loop_ms = cuda_ms(lambda: kernel(y, 22, n, use_dst=use_dst))
        k_ms = graph_ms(lambda: kernel(y, 22, n, use_dst=use_dst))
        p_ms = cuda_ms(lambda: plain(y, 22, n, use_dst=use_dst), iters=5)
        times[n] = (k_ms, p_ms)
        log(f"[{tag}] {name} 1080p luma N={n}{' DST' if use_dst else ''}: "
            f"kernel {k_ms:.4f} ms on the card ({mpix / k_ms * 1e3:.1f} "
            f"Mpix/s; CUDA graph), {loop_ms:.4f} ms a call in a launch "
            f"loop; plain {p_ms:.4f} ms ({mpix / p_ms * 1e3:.1f} Mpix/s) "
            f"[{gpu}]")
    if name == "slab_encode_plane":
        cold = cold_l2_ms(lambda: kernel(y, 22, 8), dev)
        log(f"[{tag}] {name} 1080p luma N=8 with L2 flushed before each "
            f"launch: {cold:.4f} ms ({mpix / cold * 1e3:.1f} Mpix/s, "
            f"{12 * H * W / cold / 1e6:.1f} GB/s at 12 B/pixel) [{gpu}]")
        log(f"[{tag}] {name} least operations with the butterflies: "
            f"{butterfly_bounds()}")
    return times


def butterfly_ops(n: int) -> float:
    """Integer operations a pixel of one 1-D transform pass as the row
    kernels do it (csrc/row_tail.cuh), rounding not counted: at each
    level M = n, n/2, ..., 2 the M sums and differences of mirrored
    terms, (M/2)^2 multiplies and (M/2)(M/2 - 1) adds for the odd rows,
    and one multiply at the last level; a 4x4 product (7 a pixel) for the
    DST.  kernel_bound and fused_bound count 2n, the N-term dot product,
    and stay the yardstick of earlier runs."""
    ops, m = 1, n
    while m > 1:
        h = m // 2
        ops += m + h * h + h * (h - 1)
        m = h
    return ops / n


def butterfly_bounds() -> str:
    """The slab kernel's least operations a pixel per N (four butterfly
    passes, the tail's other 18, DC/planar's 16) with the time they take
    at 67 T/s, beside the bytes' time of kernel_bound."""
    parts = []
    for n in (4, 8, 16, 32):
        per_pixel = 4 * butterfly_ops(n) + 18 + 16
        t_ops = per_pixel * H * W / 67e12 * 1e3
        t_bytes = (12 * H * W + 4 * H * W // (n * n)) / 3.35e12 * 1e3
        parts.append(f"N={n} {per_pixel:g} a pixel, {t_ops * 1e3:.2f} us "
                     f"against the bytes' {t_bytes * 1e3:.2f} us")
    return "; ".join(parts) + " (the DST at 4: 7 a pixel a pass)"


def frame_times(dev, frame: Frame, config: EncoderConfig, label: str,
                gpu: str) -> None:
    """Device part, frame call, its breakdown and the device busy share."""
    mpix = H * W / 1e6
    planes = [torch.from_numpy(p.data.astype(np.int32)).to(dev)
              for p in (frame.y, frame.u, frame.v)]
    dev_ms = cuda_ms(lambda: [encode_plane_config(p, config, i == 0)
                              for i, p in enumerate(planes)])
    log(f"[6] {label} 1080p 4:2:0 frame, device part (3 planes resident, "
        f"kernel + scan-pack): {dev_ms:.4f} ms ({mpix / dev_ms * 1e3:.1f} "
        f"Mpix/s luma) [{gpu}]")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        encode_frame_full(frame, config, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * sorted(walls)[len(walls) // 2]
    log(f"[6] {label} 1080p 4:2:0 encode_frame_full (host in, host out, "
        f"PSNR/SSIM included), median of 5: {wall_ms:.2f} ms "
        f"({mpix / wall_ms * 1e3:.2f} Mpix/s luma) [{gpu}]")
    stages = [frame_breakdown(dev, frame, config) for _ in range(5)]
    parts = ", ".join(
        f"{k} {1e3 * sorted(s[k] for s in stages)[2]:.2f}" for k in stages[0]
    )
    log(f"[6] {label} where the frame's time goes, ms (host clock, median "
        f"of 5): {parts} [{gpu}]")
    busy_us, wall_us = device_busy(
        lambda: encode_frame_full(frame, config, device=dev))
    log(f"[6] {label} device over 3 encode_frame_full calls (torch.profiler): "
        f"{busy_us:.1f} us of kernels and copies in {wall_us:.1f} us: "
        f"{busy_share(busy_us, wall_us)} [{gpu}]")


def busy_share(busy_us: float, wall_us: float) -> str:
    return (f"{100 * busy_us / wall_us:.3f} % busy, "
            f"{100 - 100 * busy_us / wall_us:.3f} % idle" if busy_us
            else "not measured (the profiler recorded no device activity)")


def device_busy(call, repeats: int = 3):
    """(device-busy us, wall us) of `repeats` call()s under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            call()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us = sum(
        evt.time_range.elapsed_us() for evt in prof.events()
        if evt.device_type == DeviceType.CUDA
    )
    return float(busy_us), wall_us


def frame_breakdown(dev, frame: Frame, config: EncoderConfig) -> dict:
    """Seconds per stage of one frame: the steps of encode_frame_full
    run one by one, each ended by a synchronise, then the bitstream."""
    clock = time.perf_counter
    out = {}
    t0 = clock()
    planes = [torch.from_numpy(p.data.astype(np.int32)).to(dev)
              for p in (frame.y, frame.u, frame.v)]
    torch.cuda.synchronize()
    out["h2d"] = clock() - t0
    t0 = clock()
    res = [encode_plane_config(p, config, i == 0) for i, p in enumerate(planes)]
    torch.cuda.synchronize()
    out["device"] = clock() - t0
    t0 = clock()
    host = [{k: v.cpu().numpy() for k, v in r.items()} for r in res]
    out["d2h"] = clock() - t0
    orig_y = frame.y.data.astype(np.uint8)
    rec_y = host[0]["recon"].astype(np.uint8)
    t0 = clock()
    oracle.psnr(orig_y, rec_y)
    out["psnr"] = clock() - t0
    t0 = clock()
    ssim_host(orig_y, rec_y)
    out["ssim"] = clock() - t0
    info = {"planes": {
        name: {"levels": h["levels"], "modes": h["modes"],
               "block_size": config.block_size if name == "Y"
               else config.chroma_block_size()}
        for name, h in zip("YUV", host)
    }}
    t0 = clock()
    assemble_frame_bitstream(W, H, config, info)
    out["entropy"] = clock() - t0
    return out


def kernel_bound(search: bool, n: int, pixels: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one encode of `pixels`
    pixels at block size n, by the slab, mode-search or wavefront kernel.

    Bytes: the int32 plane read once, recon and levels written once (12
    bytes a pixel) and one int32 mode a block.  Operations a pixel, an
    add, multiply, shift, compare or select each one: the transform
    tail 8N + 18 (two N-term multiply-add passes each way, rounding,
    quantize, dequantize, clip); DC/planar by energy 16 (planar's four
    products and sums, both energies); the search 35 modes of 2N + 10
    (prediction, residual, two N-term WHT passes, |.|, sum) plus 9 for
    planar and DC.  No step of these kernels depends on the data.  The
    count stays the yardstick of earlier runs: the butterfly WHT of
    mode_sweep.cuh needs 2 log2 N adds a pixel, not 2N, so the search's
    least operation count is lower than this one (PERF.md).
    """
    per_pixel = 8 * n + 18 + (35 * (2 * n + 10) + 9 if search else 16)
    t_bytes = (12 * pixels + 4 * pixels // (n * n)) / 3.35e12 * 1e3
    t_ops = per_pixel * pixels / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def stacked_planes(shape, bit_depth: int, batch: int, n: int, dev, rng):
    """(batch, Hp, Wp) int32 textured planes on `dev`, padded to blocks
    by edge replication as the closed loop pads them."""
    planes = np.stack([textured(*shape, bit_depth, rng) for _ in range(batch)])
    return pad_to_blocks(torch.from_numpy(planes), n).to(dev)


def phase_wavefront_vs_plain(dev) -> int:
    """The wavefront kernel == its plain version on the card, both
    bodies, every N; (bit depth, dequant rescale, batch) rotates over
    the QPs so that each QP meets every combination across the N.  Then
    the cases that stress the row schedule: a tall plane, one block row,
    one block column, the sequence's 16-plane chroma stack at N=4 (more
    rows than resident thread blocks), a 12-bit plane at N=32 (the
    search's packed key off), and the 1080p search at N=8 run three
    times, each equal to the first, so that a race shows."""
    kernel, plain = KERNELS["wavefront_encode_planes"][:2]
    rng = np.random.default_rng(SEED)
    combos = [(bd, rs, b) for bd in (8, 10) for rs in (False, True)
              for b in (1, 2)]
    sizes = ((4, False), (4, True), (8, False), (16, False), (32, False))
    cases = []
    t = 0
    for shape in ((H // 2, W // 2), (45, 200)):
        for body in WAVEFRONT_BODIES:
            for n, use_dst in sizes:
                for k, qp in enumerate((0, 22, 37, 51)):
                    cases.append((shape, body, n, use_dst, qp,
                                  *combos[(k + 3 * t) % len(combos)]))
                t += 1
    for body in WAVEFRONT_BODIES:     # 1080 rows pad to 1088 at N = 16
        for n, use_dst in ((4, True), (8, False), (16, False)):
            cases.append(((H, W), body, n, use_dst, 22, 8, False, 1))
    old_cases = len(cases)
    for body in WAVEFRONT_BODIES:
        for n in (4, 8):
            cases += [((200, 45), body, n, False, 22, 8, False, 2),
                      ((n, 200), body, n, False, 37, 8, True, 2),
                      ((200, n), body, n, False, 22, 10, False, 2)]
        cases.append(((H // 2, W // 2), body, 4, False, 22, 8, False, 16))
    for qp in (22, 37):
        cases.append(((H // 2, W // 2), "search", 32, False, qp, 12, qp == 37,
                      1))
    planes = {}
    worst = 0
    for shape, body, n, use_dst, qp, bd, rescale, batch in cases:
        key = (shape, bd, batch, n)
        if key not in planes:
            planes[key] = stacked_planes(shape, bd, batch, n, dev, rng)
        mode_set, decision = WAVEFRONT_BODIES[body]
        kw = dict(mode_set=mode_set, decision=decision, bit_depth=bd,
                  use_dst=use_dst, dequant_rescale=rescale)
        got = kernel(planes[key], qp, n, **kw)
        want = plain(planes[key], qp, n, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise SystemExit(
                f"wavefront_encode_planes != plain at {shape} body={body} "
                f"N={n} dst={use_dst} bd={bd} rescale={rescale} qp={qp} "
                f"batch={batch}: max abs err {err}")
        worst = max(worst, err)
    y = planes[(H, W), 8, 1, 8]
    kw = dict(zip(("mode_set", "decision"), WAVEFRONT_BODIES["search"]))
    first = kernel(y, 22, 8, **kw)
    for rep in range(3):
        again = kernel(y, 22, 8, **kw)
        torch.cuda.synchronize()
        if max_abs_err(again, first):
            raise SystemExit(f"wavefront_encode_planes search 1080p N=8: "
                             f"repeat {rep + 1} differs from the first run")
    log(f"[3c] wavefront_encode_planes == plain on CUDA in {len(cases)} "
        f"cases ({old_cases} + {len(cases) - old_cases} of the row schedule: "
        f"tall, one block row, one block column, 16 chroma planes at N=4, "
        f"12-bit N=32 search) (max abs err {worst}); 1080p search N=8 run "
        f"three more times, each == the first")
    return worst


def phase_wavefront_scan_vs_plain(dev) -> dict:
    """3g: what the wavefront kernel took over from JAX's closed-loop XLA
    scan == its plain version on the card, 0 differing values in recon,
    levels and modes: every body of SCAN_BODIES at N 4 (DST and DCT), 8,
    16 and 32, each with smoothing off and on; RDOQ rotated over the
    cases in every scan (off, diag, horizontal, vertical, mode) with
    lambda scales 1, 2.5 and 0.5; bit depth 8/10/12 and the dequant
    rescale rotated; QP 0/22/37/51 rotated; on a 135x240 and a 45x200
    crop (padded).  The scan turns with the body as well as with (N,
    smoothing), so that each body meets every scan with smoothing off
    and on.  Then the row schedule on grids capped at 1 and 2 thread
    blocks: each body under RDOQ on a 138x250 crop.  Then, each against
    the plain loop and run three more times, each == the first: two
    1080p luma planes at N=8, the DC/planar body under RDOQ (diag) and
    the smoothed 35-mode search; and 7d's batches under RDOQ as
    encode_sequence gives them, a batch's 8 luma planes (1080p, N=8) and
    its 16 chroma planes (540x960, N=4), the chroma batch on a grid of 2
    too.  Returns the worst error of each kernels-line row."""
    kernel, plain = KERNELS["wavefront_encode_planes"][:2]
    rng = np.random.default_rng(SEED + 5)
    sizes = ((4, True), (4, False), (8, False), (16, False), (32, False))
    rdoq_scans = (None, "diag", "horizontal", "vertical", "mode")
    combos = [(bd, rs) for bd in (8, 10, 12) for rs in (False, True)]
    cases = []
    t = 0
    for b, body in enumerate(SCAN_BODIES):
        for n, use_dst in sizes:
            for smoothing in (False, True):
                bd, rescale = combos[t % len(combos)]
                cases.append((((H // 8, W // 8), (45, 200))[t % 2], body, n,
                              use_dst, (0, 22, 37, 51)[t % 4], bd, rescale,
                              smoothing, rdoq_scans[(t + b) % 5],
                              (1.0, 2.5, 0.5)[t % 3]))
                t += 1
    planes = {}
    worst = dict.fromkeys(SCAN_ROWS, 0)
    t0 = time.perf_counter()
    for (shape, body, n, use_dst, qp, bd, rescale, smoothing, scan,
         scale) in cases:
        key = (shape, bd, n)
        if key not in planes:
            planes[key] = stacked_planes(shape, bd, 1, n, dev, rng)
        mode_set, decision = SCAN_BODIES[body]
        kw = dict(mode_set=mode_set, decision=decision, bit_depth=bd,
                  use_dst=use_dst, dequant_rescale=rescale,
                  intra_smoothing=smoothing, rdoq=scan is not None,
                  scan=scan or "diag", rd_lambda_scale=scale)
        got = kernel(planes[key], qp, n, **kw)
        want = plain(planes[key], qp, n, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise SystemExit(
                f"wavefront_encode_planes != plain at {shape} body={body} "
                f"N={n} dst={use_dst} bd={bd} rescale={rescale} qp={qp} "
                f"smoothing={smoothing} rdoq scan={scan} scale={scale}: "
                f"max abs err {err}")
        row = scan_row(mode_set, decision, smoothing and n > 4,
                       scan is not None)
        if row is not None:
            worst[row] = max(worst[row], err)
    cases_s = time.perf_counter() - t0
    # the row schedule on grids of 1 and 2 thread blocks (the word
    # hand-off with every row waiting on a thread block that codes rows
    # one after another): each body under RDOQ on a 138x250 crop, N and
    # scan turning with the body
    capped = 0
    for b, body in enumerate(SCAN_BODIES):
        n, use_dst = sizes[b % len(sizes)]
        scan = rdoq_scans[1 + b % 4]
        mode_set, decision = SCAN_BODIES[body]
        crop_planes = stacked_planes((138, 250), 8, 1, n, dev, rng)
        kw = dict(mode_set=mode_set, decision=decision, use_dst=use_dst,
                  rdoq=True, scan=scan)
        want = plain(crop_planes, 30, n, **kw)
        for cap in (1, 2):
            got = kernel(crop_planes, 30, n, _max_grid=cap, **kw)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise SystemExit(
                    f"wavefront_encode_planes != plain on a grid of {cap}: "
                    f"138x250 body={body} N={n} rdoq scan={scan}: max abs "
                    f"err {err}")
            capped += 1
    y = stacked_planes((H, W), 8, 1, 8, dev, rng)
    full = [(f"1080p luma N=8, {label}", y, 8, SCAN_ROWS[row][1])
            for label, row in (("DC/planar under RDOQ (diag)", "rdoq"),
                               ("smoothed 35-mode search", "smoothing"))]
    seq_cfg = EncoderConfig(rdoq=True)        # 7d's closed-loop RDOQ run
    for is_luma, shape, batch in ((True, (H, W), SEQ_BATCH),
                                  (False, (H // 2, W // 2), 2 * SEQ_BATCH)):
        args = torch_wf.plane_args(seq_cfg, is_luma)
        kw = {k: args[k] for k in ("mode_set", "decision", "bit_depth",
                                   "use_dst", "dequant_rescale",
                                   "intra_smoothing", "rdoq", "scan")}
        full.append((f"7d's {'luma' if is_luma else 'chroma'} batch under "
                     f"RDOQ, {batch} {shape[0]}x{shape[1]} planes N="
                     f"{args['n']}", stacked_planes(shape, 8, batch,
                                                    args["n"], dev, rng),
                     args["n"], kw))
    done = []
    for label, planes, n, kw in full:
        t1 = time.perf_counter()
        first = kernel(planes, 22, n, **kw)
        want = plain(planes, 22, n, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(first, want)
        if err:
            raise SystemExit(f"wavefront_encode_planes {label}: != plain, "
                             f"max abs err {err}")
        for rep in range(3):
            again = kernel(planes, 22, n, **kw)
            torch.cuda.synchronize()
            if max_abs_err(again, first):
                raise SystemExit(f"wavefront_encode_planes {label}: repeat "
                                 f"{rep + 1} differs from the first run")
        if label.startswith("7d's chroma"):     # and on a grid of 2
            err = max_abs_err(kernel(planes, 22, n, _max_grid=2, **kw), want)
            if err:
                raise SystemExit(f"wavefront_encode_planes {label} on a grid "
                                 f"of 2: != plain, max abs err {err}")
            label += ", == plain on a grid of 2 too"
        done.append(f"{label} ({time.perf_counter() - t1:.1f} s)")
    log(f"[3g] wavefront_encode_planes == plain on CUDA in {len(cases)} cases "
        f"of JAX's closed-loop XLA scan ({len(SCAN_BODIES)} bodies x N 4 "
        f"DST/4/8/16/32 x smoothing off/on; each body under RDOQ in every "
        f"scan, lambda scales 1/2.5/0.5; 8/10/12-bit; both dequant modes; "
        f"QP 0/22/37/51; {cases_s:.1f} s), 0 values differing; on grids of "
        f"1 and 2 thread blocks in {capped} cases (each body under RDOQ, "
        f"138x250); at full size == plain and three repeats == the first: "
        f"{'; '.join(done)}")
    return worst


# --- the RD closed loop's kernel (3h, the price sweep, 6h) -------------------

def rd_batches(dev, rng) -> list:
    """7d's two RD plane batches as encode_sequence gives them under
    EncoderConfig(decision="rd"): [(label, planes, n, keywords)], a
    batch's SEQ_BATCH luma planes (1080p, N=8) and its 2 x SEQ_BATCH
    chroma planes (540x960, N=4), seeded textured planes."""
    seq_cfg = EncoderConfig(decision="rd")
    out = []
    for is_luma, shape, batch in ((True, (H, W), SEQ_BATCH),
                                  (False, (H // 2, W // 2), 2 * SEQ_BATCH)):
        args = torch_wf.plane_args(seq_cfg, is_luma)
        kw = {k: args[k] for k in ("mode_set", "bit_depth", "use_dst",
                                   "dequant_rescale", "intra_smoothing",
                                   "rdoq", "scan")}
        out.append((f"7d's {'luma' if is_luma else 'chroma'} batch, {batch} "
                    f"{shape[0]}x{shape[1]} planes N={args['n']} "
                    f"{args['mode_set']}",
                    stacked_planes(shape, 8, batch, args["n"], dev, rng),
                    args["n"], kw))
    return out


def mixed_planes(shape, n: int, dev, rng):
    """(3, Hp, Wp) int32 planes on `dev`: a textured plane, a flat one
    and uniform noise, padded to blocks."""
    h, w = shape
    planes = np.stack([textured(h, w, 8, rng),
                       np.full((h, w), 128, np.int32),
                       rng.integers(0, 256, (h, w)).astype(np.int32)])
    return pad_to_blocks(torch.from_numpy(planes), n).to(dev)


def phase_wavefront_rd_vs_plain(dev) -> dict:
    """3h: the RD closed loop's kernel == its plain loop
    (`wavefront_rd_encode_planes_reference`) on the card, 0 values
    differing in recon, levels and modes: DC/planar and the 35 modes at
    N 4 DST, 4, 8, 16 and 32, each with smoothing off and on; RDOQ
    rotated over the cases (off and every scan) with lambda scales 1,
    2.5 and 0.5; 8/10/12-bit and the dequant rescale rotated; QP
    0/22/37/51 rotated; a 135x240 and a 45x200 crop (padded), each at
    batch 1 and 2; and, since the rotation meets N 16 and 32 only under
    RDOQ, both mode sets at N 16 and 32 without it on the 135x240 crop
    (the candidates kept in their lanes' registers, the pair decided by
    a shuffle).  Then,
    each against the plain loop and run three more times, each == the
    first: the 1080p luma plane at N=8 under each mode set, and 7d's
    batches under decision="rd" as encode_sequence gives them, a batch's
    8 luma planes (1080p, N=8) and its 16 chroma planes (540x960, N=4),
    and a batch of 270x480 planes of mixed texture (textured, flat,
    noise: frames whose blocks decide differently, so one frame runs
    ahead of another) under each mode set.  Last, 32 1080p luma planes
    under the 35 modes at N=8, more than the grid holds at once, so that
    its thread blocks code the frames in turns: the first and the last
    frame against the plain loop, three repeats == the first.  Returns
    the worst error by mode set."""
    kernel = krd.wavefront_rd_encode_planes
    rng = np.random.default_rng(SEED + 9)
    sizes = ((4, True), (4, False), (8, False), (16, False), (32, False))
    rdoq_scans = (None, "diag", "horizontal", "vertical", "mode")
    combos = [(bd, rs) for bd in (8, 10, 12) for rs in (False, True)]
    cases = []
    t = 0
    for mode_set in RD_SETS:
        for n, use_dst in sizes:
            for smoothing in (False, True):
                bd, rescale = combos[t % len(combos)]
                cases.append((((H // 8, W // 8), (45, 200))[t % 2],
                              (1, 2)[(t // 2) % 2], mode_set, n, use_dst,
                              (0, 22, 37, 51)[t % 4], bd, rescale, smoothing,
                              rdoq_scans[t % 5], (1.0, 2.5, 0.5)[t % 3]))
                t += 1
    for mode_set in RD_SETS:
        for n, smoothing in ((16, False), (32, True)):
            cases.append(((H // 8, W // 8), 1, mode_set, n, False, 22, 8,
                          False, smoothing, None, 1.0))
    planes = {}
    worst = dict.fromkeys(RD_SETS, 0)
    grids = set()
    t0 = time.perf_counter()
    for (shape, batch, mode_set, n, use_dst, qp, bd, rescale, smoothing,
         scan, scale) in cases:
        key = (shape, bd, batch, n)
        if key not in planes:
            planes[key] = stacked_planes(shape, bd, batch, n, dev, rng)
        kw = dict(mode_set=mode_set, bit_depth=bd, use_dst=use_dst,
                  dequant_rescale=rescale, intra_smoothing=smoothing,
                  rdoq=scan is not None, scan=scan or "diag",
                  rd_lambda_scale=scale)
        got = kernel(planes[key], qp, n, **kw)
        want = rd_plain(planes[key], qp, n, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise SystemExit(
                f"wavefront_rd_encode_planes != plain at {shape} batch "
                f"{batch} {mode_set} N={n} dst={use_dst} bd={bd} rescale="
                f"{rescale} qp={qp} smoothing={smoothing} rdoq scan={scan} "
                f"scale={scale}: max abs err {err}")
        worst[mode_set] = max(worst[mode_set], err)
    cases_s = time.perf_counter() - t0
    y = stacked_planes((H, W), 8, 1, 8, dev, rng)
    full = [(f"1080p luma N=8 {mode_set}", y, 8, dict(mode_set=mode_set))
            for mode_set in RD_SETS]
    full += rd_batches(dev, rng)
    mixed = mixed_planes((H // 4, W // 4), 8, dev, rng)
    full += [(f"a batch of {mixed.shape[0]} {H // 4}x{W // 4} planes of "
              f"mixed texture (textured, flat, noise) N=8 {mode_set}", mixed,
              8, dict(mode_set=mode_set)) for mode_set in RD_SETS]
    done = []
    for label, planes, n, kw in full:
        t1 = time.perf_counter()
        first = kernel(planes, 22, n, **kw)
        want = rd_plain(planes, 22, n, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(first, want)
        if err:
            raise SystemExit(f"wavefront_rd_encode_planes {label}: != plain, "
                             f"max abs err {err}")
        for rep in range(3):
            again = kernel(planes, 22, n, **kw)
            torch.cuda.synchronize()
            if max_abs_err(again, first):
                raise SystemExit(f"wavefront_rd_encode_planes {label}: repeat "
                                 f"{rep + 1} differs from the first run")
        modes_used = int((torch.bincount(first["modes"].flatten().long(),
                                         minlength=35) > 0).sum())
        done.append(f"{label} ({modes_used} modes used; "
                    f"{time.perf_counter() - t1:.1f} s)")
    done.append(rd_in_turns(dev, rng))
    log(f"[3h] wavefront_rd_encode_planes == plain on CUDA in {len(cases)} "
        f"cases (DC/planar and 35 modes x N 4 DST/4/8/16/32 x smoothing "
        f"off/on; RDOQ off and in every scan, lambda scales 1/2.5/0.5; "
        f"8/10/12-bit; both dequant modes; QP 0/22/37/51; 135x240 and "
        f"45x200 at batch 1 and 2; N 16 and 32 without RDOQ; "
        f"{cases_s:.1f} s), 0 values differing; at full size == plain and "
        f"three repeats == the first: {'; '.join(done)}")
    return worst


def rd_in_turns(dev, rng, batch: int = 32) -> str:
    """3h's batch of `batch` 1080p luma planes under the 35 modes at N=8:
    more frames than the kernel's grid holds at once (it fails unless
    so), so its thread blocks code them in turns.  The first and the last
    frame == the plain loop, and three repeats == the first; returns the
    clause of 3h's line."""
    t0 = time.perf_counter()
    planes = stacked_planes((H, W), 8, batch, 8, dev, rng)
    kw = dict(mode_set="all", bit_depth=8, use_dst=False,
              dequant_rescale=False, intra_smoothing=False, rdoq=False,
              scan="diag", rd_lambda_scale=1.0)
    first, blocks, frames = krd._launch(planes, 22, 8, **kw)
    label = (f"{batch} 1080p luma planes N=8 all, {frames} frames at once "
             f"({blocks} thread blocks)")
    if frames >= batch:
        raise SystemExit(f"wavefront_rd_encode_planes {label}: the grid "
                         "holds every frame, so no turns are checked")
    ends = [0, batch - 1]
    want = rd_plain(planes[ends], 22, 8, mode_set="all")
    torch.cuda.synchronize()
    err = max_abs_err({k: v[ends] for k, v in first.items()}, want)
    if err:
        raise SystemExit(f"wavefront_rd_encode_planes {label}: != plain, "
                         f"max abs err {err}")
    for rep in range(3):
        again = krd._launch(planes, 22, 8, **kw)[0]
        torch.cuda.synchronize()
        if max_abs_err(again, first):
            raise SystemExit(f"wavefront_rd_encode_planes {label}: repeat "
                             f"{rep + 1} differs from the first run")
    return (f"{label}, frames 1 and {batch} == plain "
            f"({time.perf_counter() - t0:.1f} s)")


def all_count_pairs(top: int) -> tuple:
    """Every (n1, n) with 0 <= n1 <= n <= top, as int64 arrays."""
    n = np.repeat(np.arange(top + 1), np.arange(1, top + 2))
    starts = np.concatenate([[0], np.cumsum(np.arange(1, top + 1))])
    return np.arange(n.size) - starts[n], n


def phase_rd_prices(dev, gpu: str) -> None:
    """The device's per-context prices (the function the RD kernel
    prices every context with) against the host's `ops.rate._prices` on
    this machine, 0 bits differing: every (n1, n) with n <= 4096, then
    10^7 seeded pairs with n up to 2^21."""
    rng = np.random.default_rng(SEED + 11)
    n_r = rng.integers(0, (1 << 21) + 1, 10 ** 7)
    n1_r = np.minimum((rng.random(n_r.size) * (n_r + 1)).astype(np.int64),
                      n_r)
    sweeps = {"every pair with n <= 4096": all_count_pairs(4096),
              "10^7 seeded pairs, n <= 2^21": (n1_r, n_r)}
    t0 = time.perf_counter()
    dev_s = 0.0
    parts = []
    for label, (n1, n) in sweeps.items():
        bad = 0
        examples = []
        for s0 in range(0, n.size, 1 << 22):
            a1, a = n1[s0:s0 + (1 << 22)], n[s0:s0 + (1 << 22)]
            t1 = time.perf_counter()
            got = krd.device_prices(
                torch.from_numpy(a1.astype(np.int32)).to(dev),
                torch.from_numpy(a.astype(np.int32)).to(dev))
            got = [g.cpu().numpy() for g in got]
            dev_s += time.perf_counter() - t1
            want = rate._prices(a1.astype(np.float32), a.astype(np.float32))
            for g, w_ in zip(got, want):
                diff = g.view(np.int32) != w_.view(np.int32)
                bad += int(diff.sum())
                for k in np.flatnonzero(diff)[:4]:
                    examples.append((int(a1[k]), int(a[k]), float(w_[k]),
                                     float(g[k])))
        if bad:
            raise SystemExit(f"device prices differ from the host's in {bad} "
                             f"values over {label}; (n1, n, host, device): "
                             f"{examples[:8]}")
        parts.append(f"{label} ({n.size} pairs)")
    log(f"[3h] RD price sweep: device prices == the host's _prices bit for "
        f"bit (ones and zeros) over {'; '.join(parts)} "
        f"({time.perf_counter() - t0:.1f} s, {dev_s:.1f} s of it device "
        f"calls and copies) [{gpu}]")


def rd_bound(mode_set: str, n: int, pixels: int, diagonals: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one RD closed-loop encode
    of `pixels` pixels at block size n over `diagonals` anti-diagonals:
    bytes as kernel_bound's (12 a pixel, 4 a block); operations a pixel,
    for each of the 2 (35) candidates the transform tail 8N + 18 plus 40
    (prediction and residual 10, SSE 2, bin counts 8, its bits 20), and
    the chosen block's tail 8N + 18 again; and the prices, 45 contexts of
    4 float64 transcendentals at about 20 operations, once a batch and
    diagonal, as the function needs them (the kernel prices them again
    in each thread block of phase B: that repetition is its own cost)."""
    cands, batches = (35, 2) if mode_set == "all" else (2, 1)
    ops = ((cands * (8 * n + 18 + 40) + 8 * n + 18) * pixels
           + batches * 45 * 4 * 20 * diagonals)
    t_bytes = (12 * pixels + 4 * pixels // (n * n)) / 3.35e12 * 1e3
    t_ops = ops / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rd_times(dev, gpu: str) -> dict:
    """6h: the RD kernel per seeded 1080p luma plane at N 4 (DST), 8, 16
    and 32, QP 22, under each mode set; at N=8 beside it the kernel's
    synchronisation alone (the same grid through the same message
    polls, counter adds and counter polls with an empty body), the
    bound and the
    plain loop once.  Then 7d's two plane batches, the kernel beside its
    synchronisation alone.  Returns {mode_set: (kernel ms, plain ms)} at
    N=8."""
    kernel = krd.wavefront_rd_encode_planes
    rng = np.random.default_rng(SEED + 1)
    out = {}
    for n, use_dst in ((4, True), (8, False), (16, False), (32, False)):
        y = stacked_planes((H, W), 8, 1, n, dev, rng)
        depth = y.shape[1] // n + y.shape[2] // n - 1
        for mode_set in RD_SETS:
            kw = dict(mode_set=mode_set, use_dst=use_dst)
            k_ms = graph_ms(lambda: kernel(y, 22, n, **kw), iters=3,
                            replays=3)
            bound_ms, by = rd_bound(mode_set, n, H * W, depth)
            line = (f"[6h] {RD_SETS[mode_set]} 1080p luma N={n}"
                    f"{' DST' if use_dst else ''}: kernel {k_ms:.4f} ms "
                    f"(CUDA graph; {depth} diagonals, one synchronisation a "
                    f"diagonal, {1e3 * k_ms / depth:.2f} us a diagonal), "
                    f"bound {1e3 * bound_ms:.2f} us ({by}, "
                    f"{100 * bound_ms / k_ms:.3f} % of it)")
            if n == 8:
                line += rd_sync_note(y, n, mode_set, k_ms)
                t1 = time.perf_counter()
                rd_plain(y, 22, n, **kw)
                torch.cuda.synchronize()
                p_ms = 1e3 * (time.perf_counter() - t1)
                out[mode_set] = (k_ms, p_ms)
                line += f"; plain loop {p_ms:.1f} ms"
            log(line + f" [{gpu}]")
    for label, planes, n, kw in rd_batches(dev, rng):
        b, hp, wp = planes.shape
        depth = hp // n + wp // n - 1
        k_ms = graph_ms(lambda: kernel(planes, 22, n, **kw), iters=3,
                        replays=3)
        # the prices: once a frame, batch and diagonal
        bound_ms, by = rd_bound(kw["mode_set"], n, b * hp * wp, b * depth)
        log(f"[6h] {label}: kernel {k_ms:.4f} ms (CUDA graph; {depth} "
            f"diagonals), bound {1e3 * bound_ms:.2f} us ({by}, "
            f"{100 * bound_ms / k_ms:.3f} % of it)"
            + rd_sync_note(planes, n, kw["mode_set"], k_ms) + f" [{gpu}]")
    return out


def rd_sync_note(planes, n: int, mode_set: str, k_ms: float) -> str:
    """The RD kernel's synchronisation alone on these planes' grid, as
    a clause of a 6h line: its thread blocks, its time and its share of
    the kernel's k_ms."""
    blocks = krd.barriers_only(planes, n, mode_set)
    s_ms = graph_ms(lambda: krd.barriers_only(planes, n, mode_set), iters=3,
                    replays=3)
    return (f"; synchronisation alone, same grid ({blocks} thread blocks) "
            f"{s_ms:.4f} ms (CUDA graph; {100 * s_ms / k_ms:.1f} % of the "
            f"kernel)")


def phase_closed_loop(dev, frame: Frame, config: EncoderConfig, tag: str):
    """Closed-loop encode of the frame on the card: the wavefront kernel
    must launch FRAME_BATCHES times (Y, then U and V as one batch) and
    every other kernel 0 times; the result must
    equal the plain path on the CPU and the per-block simulation, parse
    back, and decode on the card to the recon pixel for pixel."""
    reset_launches()
    t0 = time.perf_counter()
    recon, bits = encode_frame_closed_loop(frame, config, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[{tag}] encode_frame_closed_loop on {dev}: {first_s:.3f} s (first "
        f"call), kernel launches {launches}")
    want = {name: FRAME_BATCHES if name == "wavefront_encode_planes" else 0
            for name in KERNELS}
    if launches != want:
        raise SystemExit(f"closed loop launched {launches}, expected {want} "
                         "(Y, then U and V, through the wavefront kernel)")

    t0 = time.perf_counter()
    cpu_recon, cpu_bits = encode_frame_closed_loop(frame, config, device="cpu")
    cpu_s = time.perf_counter() - t0
    if cpu_bits != bits or not all(
            np.array_equal(getattr(recon, p).data, getattr(cpu_recon, p).data)
            for p in "yuv"):
        raise SystemExit("CUDA closed loop differs from the plain path on "
                         "the CPU")
    log(f"[{tag}] CUDA closed loop == plain path on the CPU (recon, "
        f"bitstream; plain path {cpu_s:.2f} s)")

    parsed = parse_bitstream(bits)
    for name, p in (("Y", frame.y), ("U", frame.u), ("V", frame.v)):
        args = plane_args(config, name == "Y")
        out = encode_planes_closed_loop(
            torch.from_numpy(p.data.astype(np.int32))[None].to(dev),
            config.qp, **args)
        levels = out["levels"][0].cpu().numpy()
        modes = out["modes"][0].cpu().numpy()
        if not (np.array_equal(parsed[name]["levels"], levels)
                and np.array_equal(parsed[name]["modes"], modes)):
            raise SystemExit(f"bitstream does not parse back for plane {name}")
        if name == "Y":
            raster = ops.scan_unpack(out["levels"][0].cpu(), config.scan,
                                     modes=out["modes"][0].cpu()).numpy()
            bad = oracle_gate(frame.y.data, raster, recon.y.data.astype(np.int32),
                              args["n"], config.qp,
                              search=config.mode_set == "all", closed=True)
            if bad:
                raise SystemExit(f"{bad} of 256 sampled closed-loop blocks "
                                 "differ from the per-block simulation")
            modes_y = np.bincount(modes, minlength=35)
    log(f"[{tag}] 256 sampled luma blocks == the sequential per-block "
        f"simulation (numpy oracle); bitstream {len(bits)} bytes parses "
        f"back to the same levels and modes; luma modes used "
        f"{int((modes_y > 0).sum())} of 35")

    t0 = time.perf_counter()
    decoded = counted_decode(f"[{tag}] decode_frame", 3,
                             lambda: decode_frame(bits, device=dev))
    dec_s = time.perf_counter() - t0
    if not all(np.array_equal(getattr(recon, p).data, getattr(decoded, p).data)
               for p in "yuv"):
        raise SystemExit("decode_frame on the card differs from the recon")
    y_psnr = oracle.psnr(frame.y.data.astype(np.uint8),
                         recon.y.data.astype(np.uint8))
    log(f"[{tag}] decode_frame on {dev} == encoder recon pixel for pixel "
        f"({dec_s:.3f} s, first call; decode_blocks 3 launches, no other "
        f"kernel); Y-PSNR {y_psnr:.2f} dB")
    return launches["wavefront_encode_planes"], bits, recon


def phase_cli_closed_loop(frame: Frame, bits: bytes, recon: Frame,
                          extra: list, tag: str) -> None:
    """`encode --pipeline closed-loop` then `decode`, through the CLI, in
    one process on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        src, out, rec, dec = (os.path.join(tmp, f) for f in
                              ("frame.yuv", "out.bin", "rec.yuv", "dec.yuv"))
        with open(src, "wb") as f:
            f.write(frame.to_yuv420p())
        argv = [["encode", src, "--width", str(W), "--height", str(H),
                 "--pipeline", "closed-loop", "--bitstream", out, "-o", rec,
                 *extra], ["decode", out, "-o", dec]]
        proc = subprocess.run(
            [sys.executable, "-c", "import json, sys; from nanohevc_tpu_torch"
             ".cli import main; [main(a) for a in json.loads(sys.argv[1])]",
             json.dumps(argv)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise SystemExit(f"CLI failed (rc {proc.returncode}):\n{proc.stderr}")
        with open(out, "rb") as f:
            cli_bits = f.read()
        with open(rec, "rb") as f:
            cli_rec = f.read()
        with open(dec, "rb") as f:
            cli_dec = f.read()
    if cli_bits != bits:
        raise SystemExit("CLI bitstream differs from the library encode")
    if not cli_rec == cli_dec == recon.to_yuv420p():
        raise SystemExit("CLI recon or decoded YUV differs from the recon")
    log(f"[{tag}] CLI encode {' '.join(['--pipeline closed-loop', *extra])} "
        f"on the GPU, then decode: bitstream identical ({len(bits)} bytes), "
        f"decoded YUV == recon YUV")


def wavefront_times(dev, gpu: str) -> dict:
    """The wavefront kernel and its plain version per seeded 1080p luma
    plane (padded to blocks), both bodies, N 4 (DST) to 32, QP 22."""
    kernel, plain = KERNELS["wavefront_encode_planes"][:2]
    rng = np.random.default_rng(SEED + 1)
    mpix = H * W / 1e6
    times = {}
    for body, (mode_set, decision) in WAVEFRONT_BODIES.items():
        for n in (4, 8, 16, 32):
            y = stacked_planes((H, W), 8, 1, n, dev, rng)
            kw = dict(mode_set=mode_set, decision=decision, use_dst=n == 4)
            depth = y.shape[1] // n + y.shape[2] // n - 1
            grids0, calls0 = kernel.grids, kernel.launches
            kernel(y, 22, n, **kw)
            grids = (kernel.grids - grids0) / (kernel.launches - calls0)
            k_ms = cuda_ms(lambda: kernel(y, 22, n, **kw), iters=10)
            p_ms = cuda_ms(lambda: plain(y, 22, n, **kw), iters=1, warmup=1)
            times[body, n] = (k_ms, p_ms)
            log(f"[6c] wavefront_encode_planes {body} 1080p luma N={n}"
                f"{' DST' if n == 4 else ''}: kernel {k_ms:.4f} ms "
                f"({mpix / k_ms * 1e3:.1f} Mpix/s; {grids:g} grid launch per "
                f"call, a chain of {depth} blocks, {1e3 * k_ms / depth:.2f} "
                f"us a block), plain {p_ms:.4f} ms "
                f"({mpix / p_ms * 1e3:.1f} Mpix/s) [{gpu}]")
    # batches: 8 luma planes at N=8 and the sequence's 16-plane chroma
    # stack at N=4, one launch each
    for shape, batch, n in (((H, W), 8, 8), ((H // 2, W // 2), 16, 4)):
        planes = stacked_planes(shape, 8, batch, n, dev, rng)
        for body, (mode_set, decision) in WAVEFRONT_BODIES.items():
            kw = dict(mode_set=mode_set, decision=decision)
            k_ms = cuda_ms(lambda: kernel(planes, 22, n, **kw), iters=5)
            log(f"[6c] wavefront_encode_planes {body} batch of {batch} "
                f"{shape[0]}x{shape[1]} planes N={n}: kernel {k_ms:.4f} ms "
                f"({k_ms / times[body, 8 if n == 8 else 4][0]:.2f}x one "
                f"1080p luma plane at N={n}) [{gpu}]")
    return times


# Operations a pixel of the kernels-line rows beyond the transform tail
# (kernel_bound's counts: a candidate's prediction, residual and cost
# 10, plus 2N for SATD's WHT; planar alone 10), and RDOQ's float32
# operations a coefficient (two dequantized distortions and rates, the
# trim's compare, the zeroing gain, three prefix-sum adds and the last
# position's cost: about 60).
RDOQ_OPS = 60


def scan_bound(row: str, n: int, pixels: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one encode of `pixels`
    pixels at block size n by a SCAN_ROWS row's configuration: bytes as
    kernel_bound's (12 a pixel, 4 a block), operations a pixel the tail's
    8N + 18 plus the body's (fixed 10; the pair by SATD 2 (2N + 10); the
    sweep by SAD 35 x 10 + 9; the smoothed search kernel_bound's search
    plus 12 for the filtered references; RDOQ the DC/planar body's 16
    plus RDOQ_OPS)."""
    body = {"fixed": 10, "pair": 2 * (2 * n + 10), "sweep": 35 * 10 + 9,
            "smoothing": 35 * (2 * n + 10) + 9 + 12,
            "rdoq": 16 + RDOQ_OPS}[row]
    t_bytes = (12 * pixels + 4 * pixels // (n * n)) / 3.35e12 * 1e3
    t_ops = (8 * n + 18 + body) * pixels / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_times(dev, gpu: str) -> dict:
    """6g: each SCAN_ROWS row's configuration on a seeded 1080p luma
    plane at N = 8, QP 22: the kernel through a CUDA graph (graph_ms),
    the plain loop once, and the bound; {row: (kernel ms, plain ms)}."""
    kernel, plain = KERNELS["wavefront_encode_planes"][:2]
    y = stacked_planes((H, W), 8, 1, 8, dev, np.random.default_rng(SEED + 1))
    depth = y.shape[1] // 8 + y.shape[2] // 8 - 1
    times = {}
    for row, (label, kw) in SCAN_ROWS.items():
        k_ms = graph_ms(lambda: kernel(y, 22, 8, **kw))
        p_ms = cuda_ms(lambda: plain(y, 22, 8, **kw), iters=1, warmup=1)
        bound_ms, by = scan_bound(row, 8, H * W)
        times[row] = (k_ms, p_ms)
        log(f"[6g] {label} 1080p luma N=8: kernel {k_ms:.4f} ms (CUDA "
            f"graph; {1e3 * k_ms / depth:.2f} us a block on the {depth}-block "
            f"chain), plain {p_ms:.2f} ms, bound {1e3 * bound_ms:.2f} us "
            f"({by}) [{gpu}]")
    # the rows' other bodies and switches, the kernel alone
    for kw in (dict(mode_set="planar", decision="energy"),
               dict(mode_set="dc_planar", decision="sad"),
               dict(mode_set="all", decision="energy"),
               dict(mode_set="dc_planar", decision="energy",
                    intra_smoothing=True),
               dict(mode_set="all", decision="satd", rdoq=True),
               dict(mode_set="dc_planar", decision="energy", rdoq=True,
                    scan="mode")):
        k_ms = graph_ms(lambda: kernel(y, 22, 8, **kw))
        log(f"[6g] wavefront_encode_planes {kw} 1080p luma N=8: kernel "
            f"{k_ms:.4f} ms (CUDA graph; {1e3 * k_ms / depth:.2f} us a "
            f"block) [{gpu}]")
    return times


def frame_batches(frame: Frame, dev) -> list:
    """The closed-loop frame call's plane batches, int32 on `dev`, each
    with whether it is luma: Y (1, H, W), then U and V (2, H/2, W/2)."""
    y = frame.y.data[None]
    uv = np.stack([frame.u.data, frame.v.data])
    return [(torch.from_numpy(p.astype(np.int32)).to(dev), luma)
            for p, luma in ((y, True), (uv, False))]


def closed_loop_times(dev, frame: Frame, config: EncoderConfig, label: str,
                      gpu: str) -> None:
    """The closed-loop frame call, its breakdown, the device busy share,
    and decode_frame, host in and host out."""
    mpix = H * W / 1e6
    clock = time.perf_counter

    def call():
        encode_frame_closed_loop(frame, config, device=dev)

    walls = []
    for _ in range(3):
        t0 = clock()
        call()
        walls.append(clock() - t0)
    wall_ms = 1e3 * sorted(walls)[1]
    log(f"[6c] {label} 1080p 4:2:0 encode_frame_closed_loop (host in, "
        f"bitstream out), median of 3: {wall_ms:.2f} ms "
        f"({mpix / wall_ms * 1e3:.2f} Mpix/s luma) [{gpu}]")
    stages = []
    for _ in range(3):
        out = {}
        t0 = clock()
        batches = frame_batches(frame, dev)
        torch.cuda.synchronize()
        out["h2d"] = clock() - t0
        t0 = clock()
        res = [encode_planes_closed_loop(p, config.qp,
                                         **plane_args(config, luma))
               for p, luma in batches]
        torch.cuda.synchronize()
        out["device"] = clock() - t0
        t0 = clock()
        host = [{k: v[i].cpu().numpy() for k, v in r.items()}
                for r, i in ((res[0], 0), (res[1], 0), (res[1], 1))]
        out["d2h"] = clock() - t0
        orig_y = frame.y.data.astype(np.uint8)
        rec_y = host[0]["recon"].astype(np.uint8)
        t0 = clock()
        oracle.psnr(orig_y, rec_y)
        out["psnr"] = clock() - t0
        t0 = clock()
        ssim_host(orig_y, rec_y)
        out["ssim"] = clock() - t0
        t0 = clock()
        bits = assemble_bitstream(
            W, H, config.qp,
            {name: (h["levels"], plane_args(config, name == "Y")["n"])
             for name, h in zip("YUV", host)},
            {name: h["modes"] for name, h in zip("YUV", host)},
            bit_depth=config.bit_depth, scan=config.scan,
            dequant_rescale=config.dequant_rescale,
            intra_smoothing=config.intra_smoothing,
            entropy_coder=config.entropy_coder)
        out["entropy"] = clock() - t0
        t0 = clock()
        decode_frame(bits, device=dev)
        out["decode"] = clock() - t0
        stages.append(out)
    parts = ", ".join(
        f"{k} {1e3 * sorted(s[k] for s in stages)[1]:.2f}" for k in stages[0])
    log(f"[6c] {label} closed loop, where the time goes, ms (host clock, "
        f"median of 3; decode = decode_frame from bytes to host planes): "
        f"{parts} [{gpu}]")
    busy_us, wall_us = device_busy(call)
    log(f"[6c] {label} device over 3 encode_frame_closed_loop calls "
        f"(torch.profiler): {busy_us:.1f} us of kernels and copies in "
        f"{wall_us:.1f} us: {busy_share(busy_us, wall_us)} [{gpu}]")


# --- the decode kernel (3f, 6d; launches on every decode gate) --------------

DECODE_SIZES = ((4, True), (8, False), (16, False), (32, False))
DECODE_CHUNK = 8      # decode_sequence decodes its frames 8 at a time
# decode_blocks launches of the main paths' decodes (4c, 4d, 4g, 7c, 8a-8c,
# 9d), each counted by counted_decode
DECODE_LAUNCHES = {"main": 0}


def counted_decode(what: str, want: int, call, cfg=None):
    """Run a decode route on the card with every count at 0: the decode
    kernel must launch `want` times (one a decode_planes call: 3 a
    frame, 3 a decode_sequence chunk), the filter kernels once a
    decode_planes call each where `cfg` (the stream's EncoderConfig)
    deblocks or applies SAO, and no other kernel.  Adds the launches to
    the kernels' main-path counts; returns call()."""
    reset_launches()
    out = call()
    torch.cuda.synchronize()
    got = read_launches()
    expect = {k: want if k == "decode_blocks" else 0 for k in KERNELS}
    if got != expect:
        raise SystemExit(f"{what}: launches {got}, expected {expect}")
    check_filters(what, filter_want(cfg or EncoderConfig(), want,
                                    encode=False))
    DECODE_LAUNCHES["main"] += want
    return out


def sequence_decodes(frames: int) -> int:
    """decode_blocks launches of decode_sequence over `frames` frames
    of one block size: one a plane a chunk."""
    return 3 * -(-frames // DECODE_CHUNK)


def decode_stream(shape, n: int, batch: int, seed: int, dc_only: bool):
    """A seeded stream no encoder made, (B, nb, N*N) scan-packed levels
    and (B, nb) modes: random modes 0..34 in every block; random levels
    (15 % of the coefficients, a few of them up to +-60), or with
    `dc_only` one DC level in -2..2 a block (flat residuals, so that
    arms are nearly flat: the 32x32 strong filter's case)."""
    rng = np.random.default_rng(seed)
    nb = -(-shape[0] // n) * -(-shape[1] // n)
    modes = rng.integers(0, 35, (batch, nb)).astype(np.int32)
    levels = np.zeros((batch, nb, n * n), np.int32)
    if dc_only:
        levels[..., 0] = rng.integers(-2, 3, (batch, nb))
        return levels, modes
    big = rng.random(levels.shape) < 0.05
    mag = np.where(big, rng.integers(-60, 61, levels.shape),
                   rng.integers(-3, 4, levels.shape))
    return np.where(rng.random(levels.shape) < 0.15, mag, 0).astype(
        np.int32), modes


def strong_blocks(recon: torch.Tensor, modes: torch.Tensor, n: int,
                  bit_depth: int) -> int:
    """Blocks of a smoothed N=32 decode whose references, as the decoder
    saw them (the rule's extensions, not the final recon's), took the
    strong filter with an arm that is not constant."""
    if n != 32:
        return 0
    recon, modes = recon.cpu(), modes.cpu().long()
    nby, nbx = recon.shape[1] // n, recon.shape[2] // n
    by, bx = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(nby), torch.arange(nbx), indexing="ij"))
    refs = ops.extract_refs_at(recon, by, bx, n, 1 << (bit_depth - 1))
    top, left = refs[..., :2 * n + 1], refs[..., 2 * n + 1:]
    top[..., n + 1:] *= ~((by > 0) & (bx < nbx - 1))[:, None]
    left[..., n + 1:] *= ~((bx > 0) & (by < nby - 1))[:, None]
    c, thresh = top[..., 0], 1 << (bit_depth - 5)
    flat = (((c + top[..., 2 * n] - 2 * top[..., n]).abs() < thresh)
            & ((c + left[..., 2 * n] - 2 * left[..., n]).abs() < thresh))
    ramp = (c != top[..., 2 * n]) | (c != left[..., 2 * n])
    filt = torch.from_numpy(mode_filter_flags(n))[modes]
    return int((flat & ramp & filt).sum())


def decode_kernel_case(dev, levels, modes, qps, n: int, shape, **kw):
    """decode_planes of one stream on the card (one decode_blocks
    launch), and the kernel against its plain version on the card on
    the same residual.  Returns (differing pixels, kernel recon, modes on
    the card)."""
    h, w = shape
    hp, wp = -(-h // n) * n, -(-w // n) * n
    lv = torch.from_numpy(levels).to(dev)
    md = torch.from_numpy(modes).to(dev)
    reset_launches()
    got = decode_planes(lv, md, qps, n=n, height=h, width=w, **kw)
    torch.cuda.synchronize()
    if read_launches()["decode_blocks"] != 1:
        raise SystemExit(f"decode_planes at {shape} N={n}: launches "
                         f"{read_launches()}, expected one decode_blocks")
    res = decode_residual(lv, md, qps, n=n, hp=hp, wp=wp,
                          use_dst=kw.get("use_dst", False))
    bk = dict(bit_depth=kw.get("bit_depth", 8),
              intra_smoothing=kw.get("intra_smoothing", False))
    kern = decode_blocks(res, md, n, **bk)
    plain = decode_blocks_reference(res, md, n, **bk)
    torch.cuda.synchronize()
    bad = int((kern != plain).sum())
    if not torch.equal(got, kern[:, :h, :w]):
        bad = max(bad, 1)
    return bad, kern, md


def phase_decode_vs_plain(dev, search_bits: bytes, gpu: str) -> int:
    """3f: the decode kernel == its plain version on the card, bit for
    bit, on adversarial streams (random modes 0..34, random levels, a
    QP per frame) decoded by decode_planes, one launch a call: N 4
    (DST), 8, 16, 32; smoothing off and on (N > 4); 8 and 10 bits;
    batches of 1 and 3; a block-aligned 128x256 and a misaligned 138x250
    crop; DC-only streams at N=32 whose flat arms take the strong
    filter (one block column, and 4x8 blocks); a batch of 8 1080p luma
    planes at N=8 (a decode_sequence chunk), a 1080p plane at N=32
    with smoothing, and the chroma planes of the decoders, 540x960 at
    N=4 with the DCT, one (decode_frame) and a batch of 8 (a
    decode_sequence chunk), and two planes too wide for the default W's
    lines in shared memory (N=4 at 20000 columns, N=32 at 60000), which
    take a smaller W.  At every N some case has block rows that W (the
    rows a thread block takes) does not divide.  Then the luma plane of
    the closed loop's 1080p search stream, three repeats of its kernel
    decode, each equal to the first, and its decode on grids capped at 1
    and 2 thread blocks, each equal to the plain version.  Returns the
    max abs err."""
    t0 = time.perf_counter()
    cases = []
    combos = ((8, 1), (10, 3), (8, 3), (10, 1))
    for shape in ((128, 256), (138, 250)):
        for n, dst in DECODE_SIZES:
            for smooth in (False, True) if n > 4 else (False,):
                bd, batch = combos[len(cases) % len(combos)]
                cases.append((shape, n, dst, smooth, bd, batch, False))
    for bd in (8, 10):
        cases.append(((256, 32), 32, False, True, bd, 3, True))
        cases.append(((128, 256), 32, False, True, bd, 1, True))
    cases.append(((H, W), 8, False, False, 8, DECODE_CHUNK, False))
    cases.append(((H, W), 32, False, True, 8, 1, False))
    for batch in (1, DECODE_CHUNK):
        cases.append(((H // 2, W // 2), 4, False, False, 8, batch, False))
    wide = [((28, 20000), 4, True), ((96, 60000), 32, False)]
    for shape, n, dst in wide:
        cases.append((shape, n, dst, False, 8, 1, False))
        if group_rows(n, *shape, dev.index) >= group_rows(n, H, W,
                                                          dev.index):
            raise SystemExit(f"3f: W at {shape} N={n} is not below the "
                             "default")
    strong = 0
    ragged = set()      # the N with a case whose rows W does not divide
    for i, (shape, n, dst, smooth, bd, batch, dc) in enumerate(cases):
        levels, modes = decode_stream(shape, n, batch, SEED + i, dc)
        qps = ([22, 37, 30] * 3)[:batch] if i % 2 else (
            [30, 22, 45] * 3)[:batch]
        bad, kern, md = decode_kernel_case(
            dev, levels, modes, qps, n, shape, use_dst=dst, bit_depth=bd,
            intra_smoothing=smooth)
        if bad:
            raise SystemExit(
                f"decode_blocks != plain at {shape} N={n} dst={dst} "
                f"smoothing={smooth} bd={bd} batch={batch} dc_only={dc}: "
                f"{bad} pixels differ")
        if smooth:
            strong += strong_blocks(kern, md, n, bd)
        hp, wp = kern.shape[1:]
        if (hp // n) % group_rows(n, hp, wp, dev.index):
            ragged.add(n)
    if not strong:
        raise SystemExit("3f: no 32x32 block took the strong filter")
    if ragged != {n for n, _ in DECODE_SIZES}:
        raise SystemExit(f"3f: block rows that W does not divide only at N "
                         f"{sorted(ragged)}")
    parsed = parse_bitstream(search_bits)
    y = parsed["Y"]
    qp = y.get("qp", parsed["params"]["qp"])
    n = y["block_size"]
    levels, modes = y["levels"][None], y["modes"][None].astype(np.int32)
    bad, kern, md = decode_kernel_case(dev, levels, modes, [qp], n, (H, W))
    if bad:
        raise SystemExit(f"decode_blocks != plain on the 1080p search luma "
                         f"plane: {bad} pixels differ")
    res = decode_residual(torch.from_numpy(levels).to(dev), md, [qp], n=n,
                          hp=kern.shape[1], wp=kern.shape[2])
    for rep in range(3):
        again = decode_blocks(res, md, n)
        torch.cuda.synchronize()
        if not torch.equal(again, kern):
            raise SystemExit(f"decode_blocks 1080p: repeat {rep + 1} "
                             "differs from the first run")
    for cap in (1, 2):
        grids0 = decode_blocks.grids
        capped = decode_blocks(res, md, n, _max_grid=cap)
        torch.cuda.synchronize()
        if decode_blocks.grids - grids0 != 1 or not torch.equal(capped, kern):
            raise SystemExit(f"decode_blocks 1080p on a grid capped at {cap}: "
                             "differs from the plain version")
    log(f"[3f] decode_blocks == plain on CUDA, 0 pixels differ, in "
        f"{len(cases)} adversarial cases (random modes 0..34 and levels, "
        f"a QP per frame, N 4 DST/8/16/32, smoothing off/on, 8/10-bit, "
        f"batch 1/3, 128x256 and 138x250; a batch of {DECODE_CHUNK} 1080p "
        f"luma planes at N=8, a 1080p plane at N=32 smoothed, 540x960 "
        f"chroma at N=4 DCT, batch 1 and {DECODE_CHUNK}, 28x20000 at N=4 "
        f"and 96x60000 at N=32 at a smaller W; {strong} "
        f"blocks took the 32x32 strong filter; block rows that W does not "
        f"divide at every N) and on the 1080p search stream's luma plane "
        f"(N={n}, three repeats == the first, grids capped at 1 and 2 "
        f"thread blocks == plain); each decode_planes call one launch "
        f"({time.perf_counter() - t0:.1f} s) [{gpu}]")
    return 0


def decode_bound(n: int, modes: torch.Tensor) -> tuple:
    """(bound ms, "bytes" or "operations") of decode_blocks on one
    plane whose blocks carry `modes` (no smoothing).  Bytes: the int32
    residual read and the int32 recon written (8 a pixel), one int32
    mode a block.  Operations, counted from these modes, an add,
    multiply, shift, compare or select each one: a pixel's add and clip
    (3) and its prediction, planar 9, DC none (its 2N-term sum and
    division once a block), angular 9 (fraction, index, the two-tap
    lerp); an angular block's projection array, 3N+1 samples of 4."""
    m = modes.reshape(-1).long().cpu()
    nb = m.numel()
    planar, dc = int((m == 0).sum()), int((m == 1).sum())
    angular = nb - planar - dc
    pixels = nb * n * n
    ops_count = (3 * pixels + 9 * n * n * (planar + angular)
                 + (2 * n + 2) * dc + 4 * (3 * n + 1) * angular)
    t_bytes = (8 * pixels + 4 * nb) / 3.35e12 * 1e3
    t_ops = ops_count / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def decode_times(dev, frame: Frame, gpu: str) -> tuple:
    """6d: the decode kernel per 1080p luma plane of the closed loop's
    search stream at N 4 (DST), 8, 16, 32 (and the default config's at
    N=8), QP 22: device time through a CUDA graph, a launch loop's
    stream time, grids a call, us a block on the chain, the bound, and
    beside it the time of decode_residual, the plain PyTorch step before
    the kernel; the plain version on the search stream at N=8 only.
    Returns ({N: (kernel ms, plain ms)}, the N=8 search plane's
    bound)."""
    y = torch.from_numpy(frame.y.data.astype(np.int32))[None].to(dev)
    times, bound = {}, None
    for label, mode_set, decision in (("search", "all", "satd"),
                                      ("default", "dc_planar", "energy")):
        for n, dst in DECODE_SIZES:
            if label == "default" and n != 8:
                continue
            out = encode_planes_closed_loop(y, 22, n=n, mode_set=mode_set,
                                            decision=decision, use_dst=dst)
            hp, wp = -(-H // n) * n, -(-W // n) * n
            md = out["modes"].contiguous()
            res = decode_residual(out["levels"], md, [22], n=n, hp=hp,
                                  wp=wp, use_dst=dst)
            call = lambda: decode_blocks(res, md, n)   # noqa: E731
            r_ms = graph_ms(lambda: decode_residual(
                out["levels"], md, [22], n=n, hp=hp, wp=wp, use_dst=dst))
            grids0, calls0 = decode_blocks.grids, decode_blocks.launches
            rec = call()
            torch.cuda.synchronize()
            if not torch.equal(rec[:, :H, :W], out["recon"]):
                raise SystemExit(f"6d: decode_blocks N={n} {label}: the "
                                 "decode differs from the encoder's recon")
            grids = (decode_blocks.grids - grids0) / (
                decode_blocks.launches - calls0)
            k_ms = graph_ms(call)
            loop_ms = cuda_ms(call, iters=10)
            depth = hp // n + wp // n - 1
            b_ms, b_by = decode_bound(n, md)
            p_ms = None
            if label == "search":
                if n == 8:     # the plain loop on one 1080p plane only
                    p_ms = cuda_ms(lambda: decode_blocks_reference(res, md, n),
                                   iters=1, warmup=1)
                    bound = (b_ms, b_by)
                times[n] = (k_ms, p_ms)
            plain_note = (f", plain {p_ms:.4f} ms" if p_ms is not None
                          else "")
            log(f"[6d] decode_blocks {label} stream, 1080p luma N={n}"
                f"{' DST' if dst else ''}: kernel {k_ms:.4f} ms (CUDA graph; "
                f"launch loop {loop_ms:.4f} ms), {grids:g} grid a call, a "
                f"chain of {depth} blocks, {1e3 * k_ms / depth:.3f} us a "
                f"block; bound {1e3 * b_ms:.2f} us ({b_by}, "
                f"{100 * b_ms / k_ms:.2f} %){plain_note}; before it, "
                f"decode_residual (plain PyTorch: unpack, dequantize, "
                f"inverse transform) {r_ms:.4f} ms (CUDA graph) [{gpu}]")
    return times, bound


def decode_frame_split(dev, bits: bytes, label: str, gpu: str) -> None:
    """6d: decode_frame of a 1080p 4:2:0 stream, host bytes in and host
    planes out, and where its time goes: the host parse
    (`parse_bitstream`, median of 3 beside the calls'), and the device's
    busy time over 3 calls (torch.profiler: the residual's kernels, the
    decode kernel, the copies); the rest is host dispatch and copies."""
    clock = time.perf_counter
    walls, parses = [], []
    for _ in range(3):
        t0 = clock()
        decode_frame(bits, device=dev)
        walls.append(clock() - t0)
        t0 = clock()
        parse_bitstream(bits)
        parses.append(clock() - t0)
    busy_us, wall_us = device_busy(lambda: decode_frame(bits, device=dev))
    log(f"[6d] decode_frame {label}, 1080p 4:2:0 ({len(bits)} bytes): "
        f"{1e3 * sorted(walls)[1]:.2f} ms (median of 3; the plain loop "
        f"took 1206 / 1276 ms default / search on an H100, PERF.md section "
        f"5), of which the host parse "
        f"{1e3 * sorted(parses)[1]:.2f} ms; device over 3 calls "
        f"(torch.profiler): {busy_us:.1f} us of kernels and copies in "
        f"{wall_us:.1f} us: {busy_share(busy_us, wall_us)} [{gpu}]")


# --- K5, the blocks-API fused pipeline (3e, 4e, 6e) --------------------------

def fused_bound(n: int, pixels: int) -> tuple:
    """(bound ms, "bytes" or "operations") of fused_encode_blocks over
    `pixels` pixels at block size n: per pixel 4 bytes of block, (4N+2)
    int32 references per block, 8 bytes of recon and levels; the slab
    kernel's DC/planar operation count, 8N + 34 a pixel."""
    t_bytes = (12 * pixels + 4 * (4 * n + 2) * pixels // (n * n)) / 3.35e12 * 1e3
    t_ops = (8 * n + 34) * pixels / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_fused_vs_plain(dev) -> int:
    """3e: K5 == its plain version on the card, exactly, over N 4-32,
    8/10-bit and QP 0/22/37/51, on a batch of two 1080p luma planes and
    a 45x200 plane (ragged rows and columns, part-empty thread blocks);
    then K5 == K1 (DCT, parity, 8-bit) on the 1080p plane's full block
    rows; then the adversarial plane at 8/10/12 bits and QP 0/51 (== K1
    too at 8 bits), and blocks 4 bytes past a 16-byte boundary == the
    aligned blocks through one counted copy a call."""
    rng = np.random.default_rng(SEED)
    worst, cases, cross = 0, 0, 0
    for batch, h, w in ((2, H, W), (1, 45, 200)):
        for bd in (8, 10):
            planes = torch.from_numpy(np.stack(
                [textured(h, w, bd, rng) for _ in range(batch)])).to(dev)
            for n in (4, 8, 16, 32):
                for qp in (0, 22, 37, 51):
                    got = fused_encode_planes(planes, qp, n, bit_depth=bd)
                    want = fused_encode_planes_reference(planes, qp, n,
                                                         bit_depth=bd)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    if err:
                        raise SystemExit(
                            f"fused_encode_blocks != plain at {(batch, h, w)} "
                            f"N={n} bd={bd} qp={qp}: max abs err {err}")
                    worst = max(worst, err)
                    cases += 1
                    if h == H and bd == 8:
                        cross += same_as_slab(planes[0], got, qp, n)
    edge_cases = 0
    for bd in (8, 10, 12):
        for n in (4, 8, 16, 32):
            planes = torch.from_numpy(edge_plane(H, W, bd, n)[None]).to(dev)
            for qp in (0, 51):
                got = fused_encode_planes(planes, qp, n, bit_depth=bd)
                want = fused_encode_planes_reference(planes, qp, n,
                                                     bit_depth=bd)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                if err:
                    raise SystemExit(
                        f"fused_encode_blocks != plain on the adversarial "
                        f"plane at N={n} bd={bd} qp={qp}: max abs err {err}")
                edge_cases += 1
                if bd == 8:
                    cross += same_as_slab(planes[0], got, qp, n)
    copies = fused_encode_blocks.copies
    y = torch.from_numpy(textured(H, W, 8, np.random.default_rng(SEED + 4))).to(dev)
    for n in (4, 8, 16, 32):
        blocks = ops.tile_plane(y, n).contiguous()
        refs = ops.extract_refs(y, n)
        got = fused_encode_blocks(misaligned(blocks), refs, 22)
        want = fused_encode_blocks(blocks, refs, 22)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"fused_encode_blocks on misaligned blocks != "
                             f"aligned at N={n}")
    if fused_encode_blocks.copies != copies + 4:
        raise SystemExit(f"fused_encode_blocks counted "
                         f"{fused_encode_blocks.copies - copies} copies of "
                         f"misaligned blocks, expected 4")
    log(f"[3e] fused_encode_blocks == plain on CUDA in {cases} cases and "
        f"{edge_cases} adversarial ones (8/10/12-bit, QP 0/51; max abs err "
        f"{worst}); == slab_encode_plane (DCT, parity, 8-bit) on the full "
        f"block rows of a 1080p plane in {cross} cases; misaligned blocks "
        f"== aligned in 4 cases, one counted copy each")
    return worst


def same_as_slab(plane, got: dict, qp: int, n: int) -> int:
    """1 when K5's outputs on one plane equal K1's (DCT, parity, 8-bit)
    over the plane's full block rows; raises otherwise."""
    k1 = slab_encode_plane(plane, qp, n)
    rows = (plane.shape[0] // n) * n
    if not (torch.equal(got["recon"][0, :rows], k1["recon"][:rows])
            and torch.equal(got["levels"][0], k1["levels"].reshape(-1, n * n))):
        raise SystemExit(f"fused_encode_blocks != slab_encode_plane at N={n} "
                         f"qp={qp}")
    return 1


def phase_fused_main(dev):
    """4e: fused_encode_planes on 8 seeded 1080p luma planes: one
    launch; the 270x480 corner equals the plain version on the CPU run
    on that crop; 256 sampled blocks match the numpy oracle (fill 128,
    no DST)."""
    rng = np.random.default_rng(SEED + 2)
    planes = torch.from_numpy(np.stack(
        [textured(H, W, 8, rng) for _ in range(8)])).to(dev)
    reset_launches()
    t0 = time.perf_counter()
    out = fused_encode_planes(planes, 22, 8)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[4e] fused_encode_planes on 8 1080p luma planes: {first_s:.3f} s "
        f"(first call), kernel launches {launches}")
    want = {name: 1 if name == "fused_encode_blocks" else 0 for name in KERNELS}
    if launches != want:
        raise SystemExit(f"fused_encode_planes launched {launches}, "
                         f"expected {want}")
    ch, cw = 270, 480
    cpu = fused_encode_planes_reference(planes[:, :ch, :cw].cpu(), 22, 8)
    rows = (ch // 8) * 8
    idx = (torch.arange(ch // 8)[:, None] * (W // 8)
           + torch.arange(cw // 8)[None]).reshape(-1).to(dev)
    if not (torch.equal(out["recon"][:, :rows, :cw].cpu(), cpu["recon"][:, :rows])
            and torch.equal(out["levels"][:, idx].cpu(), cpu["levels"])
            and not cpu["recon"][:, rows:].any()):
        raise SystemExit("fused_encode_planes on the card differs from the "
                         "plain version on the CPU over a 270x480 crop")
    bad = oracle_gate(planes[0].cpu().numpy(),
                      out["levels"][0].reshape(-1, 8, 8).cpu().numpy(),
                      out["recon"][0].cpu().numpy(), 8, 22)
    if bad:
        raise SystemExit(f"{bad} of 256 sampled K5 blocks differ from the oracle")
    log("[4e] == plain path on the CPU over the 270x480 crop (recon, levels, "
        "zero fill); 256 sampled blocks == numpy oracle")
    return launches["fused_encode_blocks"], planes


def fused_times(dev, planes8, gpu: str) -> dict:
    """6e: K5 and its plain version per seeded 1080p luma plane, N 4-32,
    and per batch of 8 at N = 8, QP 22, CUDA events."""
    rng = np.random.default_rng(SEED + 1)
    y = torch.from_numpy(textured(H, W, 8, rng)).to(dev)
    mpix = H * W / 1e6
    times = {}
    for n in (4, 8, 16, 32):
        blocks = ops.tile_plane(y, n).contiguous()
        refs = ops.extract_refs(y, n)
        loop_ms = cuda_ms(lambda: fused_encode_blocks(blocks, refs, 22))
        k_ms = graph_ms(lambda: fused_encode_blocks(blocks, refs, 22))
        p_ms = cuda_ms(lambda: fused_encode_blocks_reference(blocks, refs, 22),
                       iters=5)
        bound_ms, by = fused_bound(n, H * W)
        times[n] = (k_ms, p_ms)
        log(f"[6e] fused_encode_blocks 1080p luma N={n}: kernel {k_ms:.4f} ms "
            f"on the card ({mpix / k_ms * 1e3:.1f} Mpix/s; CUDA graph), "
            f"{loop_ms:.4f} ms a call in a launch loop; plain {p_ms:.4f} ms, "
            f"bound {bound_ms * 1e3:.2f} us ({by}) [{gpu}]")
        if n == 8:
            cold = cold_l2_ms(lambda: fused_encode_blocks(blocks, refs, 22), dev)
            log(f"[6e] fused_encode_blocks 1080p luma N=8 with L2 flushed "
                f"before each launch: {cold:.4f} ms [{gpu}]")
    blocks8 = torch.stack([ops.tile_plane(p, 8) for p in planes8]).reshape(-1, 8, 8)
    refs8 = torch.stack([ops.extract_refs(p, 8) for p in planes8]).reshape(-1, 34)
    k_ms = graph_ms(lambda: fused_encode_blocks(blocks8, refs8, 22))
    p_ms = cuda_ms(lambda: fused_encode_blocks_reference(blocks8, refs8, 22),
                   iters=3)
    call_ms = cuda_ms(lambda: fused_encode_planes(planes8, 22, 8), iters=10)
    bound_ms, by = fused_bound(8, 8 * H * W)
    log(f"[6e] fused_encode_blocks batch of 8 1080p luma planes N=8: kernel "
        f"{k_ms:.4f} ms ({8 * mpix / k_ms * 1e3:.1f} Mpix/s), plain "
        f"{p_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by}); the whole "
        f"fused_encode_planes call (tiling, references, kernel, untiling) "
        f"{call_ms:.4f} ms [{gpu}]")
    return times


# --- the sequence runner (4f, 4g, 4h, 5d, 6f) -------------------------------

SEQ_FRAMES, SEQ_BATCH = 16, 8
SEQ_CONFIGS = {"default": (EncoderConfig(), False),
               "mode search": (MODE_SEARCH, False),
               "closed loop default": (EncoderConfig(), True),
               "closed loop mode search": (MODE_SEARCH, True)}


def sequence_frames(count: int, h: int, w: int, seed: int) -> list:
    """`count` distinct seeded frames: three textured planes, each
    rolled by a frame-dependent offset."""
    rng = np.random.default_rng(seed)
    base = (textured(h, w, 8, rng), textured(h // 2, w // 2, 8, rng),
            textured(h // 2, w // 2, 8, rng))
    return [Frame(*(Plane(np.roll(p, (5 * i * (k + 1), 11 * i), axis=(0, 1))
                          .astype(np.int16)) for k, p in enumerate(base)))
            for i in range(count)]


def write_yuv(path: str, frames: list) -> str:
    with open(path, "wb") as f:
        for fr in frames:
            f.write(fr.to_yuv420p())
    return path


def run_sequence(dev, src: str, bits: str, config: EncoderConfig,
                 closed: bool, frames: int = SEQ_FRAMES, **kw):
    """encode_sequence of the 1080p file at batch 8, from scratch unless
    `resume` is given."""
    return seq.encode_sequence(src, W, H, frames, config, bits,
                               batch=SEQ_BATCH, closed_loop=closed,
                               device=dev, **{"resume": False, **kw})


def same_planes(parsed: dict, want: dict) -> bool:
    """Levels and modes of planes Y, U, V of two parsed frames."""
    return all(np.array_equal(parsed[p][k], want[p][k])
               for p in "YUV" for k in ("levels", "modes"))


def phase_sequence_open(dev, tmp: str, src: str, frames: list, label: str,
                        config: EncoderConfig, tag: str):
    """4f: encode_sequence, open loop: K1 (or K2) launches 3 x 16 times
    and no other kernel; each frame parses back to encode_frame_full's
    levels and modes; a 4-frame 270x480 sequence gives the same bytes
    on the card as on the CPU."""
    path = ("slab_encode_plane" if config.mode_set == "dc_planar"
            else "mode_search_encode_plane")
    bits = os.path.join(tmp, f"{tag}.bin")
    reset_launches()
    t0 = time.perf_counter()
    res = run_sequence(dev, src, bits, config, False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[{tag}] encode_sequence {label}, 16 1080p frames, batch 8: "
        f"{first_s:.3f} s (first call), {res.bytes_written} bytes, mean Y-PSNR "
        f"{res.mean_psnr_y:.2f} dB, kernel launches {launches}")
    SEQ_RESULTS[label] = res
    want = {name: 3 * SEQ_FRAMES if name == path else 0 for name in KERNELS}
    if launches != want or res.frames != SEQ_FRAMES:
        raise SystemExit(f"sequence launched {launches} for {res.frames} "
                         f"frames, expected {want}")
    parsed = seq.decode_sequence_levels(bits)
    for i, fr in enumerate(frames):
        _, info = encode_frame_full(fr, config, device=dev)
        if not same_planes(parsed[i], info["planes"]):
            raise SystemExit(f"sequence frame {i} differs from encode_frame_full")
    log(f"[{tag}] each of the 16 frames parses back to encode_frame_full's "
        f"levels and modes on the card")
    small = write_yuv(os.path.join(tmp, f"{tag}_small.yuv"),
                      sequence_frames(4, 270, 480, SEED + 5))
    got = []
    for d in (dev, "cpu"):
        out = os.path.join(tmp, f"{tag}_small_{torch.device(d).type}.bin")
        seq.encode_sequence(small, 480, 270, 4, config, out, batch=SEQ_BATCH,
                            resume=False, device=d)
        with open(out, "rb") as f:
            got.append(f.read())
    if got[0] != got[1]:
        raise SystemExit("4-frame 270x480 sequence: card bytes != CPU bytes")
    log(f"[{tag}] 4-frame 270x480 sequence: bytes on the card == plain path "
        f"on the CPU ({len(got[0])} bytes)")
    return launches[path], bits


def phase_sequence_closed(dev, tmp: str, src: str, frames: list, label: str,
                          config: EncoderConfig, tag: str):
    """4g: the closed-loop sequence: the wavefront kernel launches twice
    a batch (luma batch, chroma stack), no other kernel; each frame
    parses back to encode_frame_closed_loop's levels and modes; and
    decode_sequence on the card gives its recon pixel for pixel."""
    bits = os.path.join(tmp, f"{tag}.bin")
    reset_launches()
    t0 = time.perf_counter()
    res = run_sequence(dev, src, bits, config, True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[{tag}] encode_sequence {label}, 16 1080p frames, batch 8: "
        f"{first_s:.3f} s (first call), {res.bytes_written} bytes, mean "
        f"Y-PSNR {res.mean_psnr_y:.2f} dB, kernel launches {launches}")
    SEQ_RESULTS[label] = res
    batches = -(-SEQ_FRAMES // SEQ_BATCH)
    want = {name: 2 * batches if name == "wavefront_encode_planes" else 0
            for name in KERNELS}
    if launches != want or res.frames != SEQ_FRAMES:
        raise SystemExit(f"closed-loop sequence launched {launches}, "
                         f"expected {want}")
    parsed = seq.decode_sequence_levels(bits)
    recon = []
    for i, fr in enumerate(frames):
        rec, fbits = encode_frame_closed_loop(fr, config, device=dev)
        if not same_planes(parsed[i], parse_bitstream(fbits)):
            raise SystemExit(f"closed-loop sequence frame {i} differs from "
                             "encode_frame_closed_loop")
        recon.append(rec.to_yuv420p())
    dec = os.path.join(tmp, f"{tag}_dec.yuv")
    t0 = time.perf_counter()
    n = counted_decode(f"[{tag}] decode_sequence",
                       sequence_decodes(SEQ_FRAMES),
                       lambda: seq.decode_sequence(bits, dec, device=dev))
    dec_s = time.perf_counter() - t0
    with open(dec, "rb") as f:
        if n != SEQ_FRAMES or f.read() != b"".join(recon):
            raise SystemExit("decode_sequence on the card != the recon")
    log(f"[{tag}] each frame parses back to encode_frame_closed_loop's levels "
        f"and modes; decode_sequence on {dev} == recon pixel for pixel "
        f"({dec_s:.3f} s for 16 frames, first call; decode_blocks "
        f"{sequence_decodes(SEQ_FRAMES)} launches, one a plane a chunk of "
        f"{DECODE_CHUNK}, no other kernel)")
    return launches["wavefront_encode_planes"], bits, b"".join(recon)


def phase_rate_and_resume(dev, tmp: str, src: str, straight_bits: str,
                          bpp_at_22: float, gpu: str) -> dict:
    """4h: target_bpp rate control, open and closed loop (QP schedule,
    achieved bpp); 8 frames then resumed to 16 == a straight 16-frame
    run; a corrupt sidecar restarts from frame 0."""
    target = round(bpp_at_22 / 2, 3)
    rc_bits = {}
    for closed in (False, True):
        bits = os.path.join(tmp, f"rc_{int(closed)}.bin")
        res = run_sequence(dev, src, bits, EncoderConfig(), closed,
                           target_bpp=target)
        qps = [fr["Y"].get("qp") for fr in seq.decode_sequence_levels(bits)]
        rc = res.stats["rate_control"]
        log(f"[4h] target_bpp {target} ({'closed' if closed else 'open'} "
            f"loop): per-frame QP {qps}, achieved {rc['achieved_bpp']:.4f} bpp "
            f"(QP {rc['qp_start']} -> {rc['qp_final']}) [{gpu}]")
        if len(qps) != SEQ_FRAMES:
            raise SystemExit("rate-controlled sequence lost frames")
        rc_bits[closed] = (bits, target)
    with open(straight_bits, "rb") as f:
        straight = f.read()
    with open(straight_bits + ".progress") as f:
        straight_side = f.read()
    bits = os.path.join(tmp, "resumed.bin")
    first = run_sequence(dev, src, bits, EncoderConfig(), False, frames=8,
                         resume=True)
    res = run_sequence(dev, src, bits, EncoderConfig(), False, resume=True)
    with open(bits, "rb") as f, open(bits + ".progress") as g:
        if (first.frames, res.resumed_from, res.frames) != (8, 8, 16) or \
                f.read() != straight or g.read() != straight_side:
            raise SystemExit("8 frames resumed to 16 != a straight 16-frame run")
    with open(bits + ".progress", "w") as f:
        f.write("{broken json")
    res = run_sequence(dev, src, bits, EncoderConfig(), False, frames=8,
                       resume=True)
    with open(bits, "rb") as f:
        data = f.read()
    if res.resumed_from != 0 or len(data) != res.bytes_written or \
            data != straight[:len(data)]:
        raise SystemExit("a corrupt sidecar did not restart from frame 0")
    log("[4h] 8 frames, then resumed to 16: byte-identical to the straight "
        "run (bitstream and sidecar); a corrupt sidecar restarts from frame 0")
    return rc_bits


# 4i: closed-loop configs no earlier phase runs on the card, each on the
# wavefront kernel (luma smoothing, the non-diagonal scans, the dequant
# rescale, a chroma mode set, the mode sets and decisions of JAX's XLA
# scan, RDOQ under the mode scan).
SCAN_CONFIGS = {
    "smoothing, mode search": EncoderConfig(mode_set="all", decision="satd",
                                            intra_smoothing=True),
    "smoothing, horizontal scan": EncoderConfig(intra_smoothing=True,
                                                scan="horizontal"),
    'decision="sad", vertical scan': EncoderConfig(decision="sad",
                                                   scan="vertical"),
    'decision="satd", dequant_rescale, mode scan': EncoderConfig(
        decision="satd", dequant_rescale=True, scan="mode"),
    'mode_set="all", decision="energy"': EncoderConfig(mode_set="all",
                                                       decision="energy"),
    'mode_set="all", decision="sad", smoothing': EncoderConfig(
        mode_set="all", decision="sad", intra_smoothing=True),
    'chroma_mode_set="dc"': EncoderConfig(chroma_mode_set="dc"),
    'chroma_mode_set="planar", rdoq, mode scan': EncoderConfig(
        chroma_mode_set="planar", rdoq=True, scan="mode"),
}


def scan_config_case(dev, what: str, small: Frame, cfg: EncoderConfig):
    """One closed-loop frame on the card with every count at 0: the
    wavefront kernel once for Y and once for U and V and nothing else, no
    plain-loop entry;
    == the CPU's recon and bytes; the stream decoded on the card (3
    decode launches) == the recon.  Returns (bytes, {row: launches})."""
    reset_launches()
    with PlainLoopEntries() as entries:
        card = encode_frame_closed_loop(small, cfg, device=dev)
        torch.cuda.synchronize()
    launches = read_launches()
    want = {k: FRAME_BATCHES if k == "wavefront_encode_planes" else 0
            for k in KERNELS}
    if launches != want or entries.count:
        raise SystemExit(f"{what}: launches {launches}, plain-loop entries "
                         f"{entries.count}; expected {want} and none")
    rows = add_scan_launches()
    cpu = encode_frame_closed_loop(small, cfg, device="cpu")
    if card[1] != cpu[1] or not same_frames(card[0], cpu[0]):
        raise SystemExit(f"{what}: the card differs from the CPU")
    decoded = counted_decode(f"{what} decode_frame", 3,
                             lambda: decode_frame(card[1], device=dev))
    if not same_frames(decoded, card[0]):
        raise SystemExit(f"{what}: decode_frame on the card != recon")
    return card[1], rows


def phase_scan_configs(dev, frame: Frame, gpu: str) -> None:
    """4i: SCAN_CONFIGS on a 256x256 and a 138x250 crop, and the default
    config at 10 bits on the 1080p frame, each by scan_config_case."""
    t0 = time.perf_counter()
    rows = {}
    sizes = []
    for h, w in ((256, 256), (138, 250)):
        small = crop(frame, h, w)
        for label, cfg in SCAN_CONFIGS.items():
            bits, got = scan_config_case(dev, f"[4i] {label}, {h}x{w}",
                                         small, cfg)
            sizes.append(len(bits))
            for row, n in got.items():
                rows[row] = rows.get(row, 0) + n
    frame10 = ten_bit(frame, np.random.default_rng(SEED + 7))
    bits10, got = scan_config_case(dev, "[4i] 10-bit 1080p", frame10,
                                   EncoderConfig(bit_depth=10))
    log(f"[4i] {2 * len(SCAN_CONFIGS)} closed-loop crops ("
        f"{'; '.join(SCAN_CONFIGS)}; 256x256 and 138x250) and the 10-bit "
        f"1080p frame ({len(bits10)} "
        f"bytes): card == CPU in recon and bytes, {FRAME_BATCHES} wavefront "
        f"launches a "
        f"frame and no plain-loop entry, each stream decoded on the card to "
        f"its recon; crop bytes {min(sizes)}-{max(sizes)}; launches by "
        f"kernels-line row {rows} ({time.perf_counter() - t0:.1f} s) [{gpu}]")


def phase_cli_sequence(dev, tmp: str, src: str, frame0: Frame,
                       want: dict) -> None:
    """5d: the CLI on the card, in one process: encode-seq (open loop,
    closed loop, --target-bpp) == the API's bytes; decode of the
    closed-loop sequence == its recon; encode --target-bytes picks
    find_frame_qp's QP."""
    geo = ["--width", str(W), "--height", str(H)]
    seq_args = ["encode-seq", src, *geo, "--frames", str(SEQ_FRAMES),
                "--batch", str(SEQ_BATCH), "--no-resume"]
    outs = {k: os.path.join(tmp, f"cli_{k}.bin") for k in ("open", "closed", "rc")}
    dec = os.path.join(tmp, "cli_dec.yuv")
    one = write_yuv(os.path.join(tmp, "frame0.yuv"), [frame0])
    budget = want["target_bytes"]
    argv = [
        seq_args + ["--bitstream", outs["open"]],
        seq_args + ["--bitstream", outs["closed"], "--closed-loop"],
        seq_args + ["--bitstream", outs["rc"], "--target-bpp",
                    str(want["target_bpp"])],
        ["decode", outs["closed"], "-o", dec],
        ["encode", one, *geo, "--pipeline", "full", "--target-bytes",
         str(budget), "--bitstream", os.path.join(tmp, "cli_tb.bin")],
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import json, sys; from nanohevc_tpu_torch"
         ".cli import main; [main(a) for a in json.loads(sys.argv[1])]",
         json.dumps(argv)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"CLI failed (rc {proc.returncode}):\n{proc.stderr}")
    for k in outs:
        with open(outs[k], "rb") as f, open(want[k], "rb") as g:
            if f.read() != g.read():
                raise SystemExit(f"CLI encode-seq ({k}) bytes != the API's")
    with open(dec, "rb") as f:
        if f.read() != want["recon"]:
            raise SystemExit("CLI decode of the sequence != the recon")
    qp, size = find_frame_qp(frame0, EncoderConfig(), budget, closed_loop=False,
                             device=dev)
    line = f"Rate search: QP {qp} fits {budget} bytes ({size} coded)"
    if line not in proc.stdout:
        raise SystemExit(f"CLI --target-bytes did not pick find_frame_qp's "
                         f"QP {qp}:\n{proc.stdout}")
    log(f"[5d] CLI on the GPU ({cli_s:.1f} s): encode-seq open loop, closed "
        f"loop and --target-bpp {want['target_bpp']} == the API's bytes; "
        f"decode of the closed-loop sequence == recon YUV; encode "
        f"--target-bytes {budget} -> QP {qp} ({size} bytes) == find_frame_qp")


class OverlapProbe:
    """Records, for each drain but the last, whether the batch
    dispatched after it was still running on the card when the drain's
    fetch began and when it returned."""

    def __enter__(self):
        self.batches, self.next_running = [], []
        self.real = (seq._BatchFetch.__init__, seq._BatchFetch.fetch)
        real_init, real_fetch = self.real
        probe = self

        def init(fetch, *a, **kw):
            real_init(fetch, *a, **kw)
            probe.batches.append(fetch)

        def fetch(fetch_, stream):
            i = probe.batches.index(fetch_)
            nxt = probe.batches[i + 1] if i + 1 < len(probe.batches) else None
            before = nxt is not None and not nxt.event.query()
            out = real_fetch(fetch_, stream)
            if nxt is not None:
                probe.next_running.append((before, not nxt.event.query()))
            return out

        seq._BatchFetch.__init__, seq._BatchFetch.fetch = init, fetch
        return self

    def __exit__(self, *exc):
        seq._BatchFetch.__init__, seq._BatchFetch.fetch = self.real
        return False


def drain_waits_on_its_event_only(dev, frames: list, gpu: str) -> None:
    """6f: one closed-loop batch of 8 frames is dispatched, then about
    1 s of other work (a spin kernel, standing in for batch i+1) is
    enqueued behind it.  The batch's fetch (27-90 ms of host copies
    beside an NVIDIA H100 80GB HBM3, PERF.md) must return before half
    the spin is over; a plain .cpu() of the same levels waits for all
    of it."""
    clock = time.perf_counter
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    spin_ms = 1000
    spin = int(10 ** 8 * spin_ms / start.elapsed_time(end))
    luma = make_closed_loop_encoder(EncoderConfig(), is_luma=True)
    chroma = make_closed_loop_encoder(EncoderConfig(), is_luma=False)
    ys = torch.from_numpy(np.stack([f.y.data for f in frames[:8]])
                          .astype(np.int32)).to(dev)
    uvs = torch.from_numpy(np.stack([f.u.data for f in frames[:8]]
                                    + [f.v.data for f in frames[:8]])
                           .astype(np.int32)).to(dev)
    copy_stream = torch.cuda.Stream(dev)
    took = {}
    for how in ("event", "plain"):
        y_out, c_out = luma(ys, 22), chroma(uvs, 22)
        fetch = seq._BatchFetch(y_out, c_out, dev)
        torch.cuda._sleep(spin)
        t0 = clock()
        if how == "event":
            fetch.fetch(copy_stream)
        else:
            y_out["levels"].cpu(), c_out["levels"].cpu()
        took[how] = 1e3 * (clock() - t0)
        torch.cuda.synchronize()
    log(f"[6f] drain of a closed-loop batch with ~{spin_ms} ms of other work "
        f"enqueued behind it: the sequence's fetch {took['event']:.1f} ms, a "
        f"plain .cpu() of the same levels {took['plain']:.1f} ms [{gpu}]")
    if took["event"] > spin_ms / 2:
        raise SystemExit("the sequence's fetch waited for work enqueued "
                         "after its batch")


def entropy_split(dev, frames: list, gpu: str) -> None:
    """6f: where the entropy stage of one 1080p frame goes: the coder
    (`assemble_bitstream`) and the parameter-set strip (NAL split and
    re-wrap) that the sequence adds, host clock."""
    config = EncoderConfig()
    _, info = encode_frame_full(frames[0], config, device=dev)
    clock = time.perf_counter
    t0 = clock()
    bits = assemble_bitstream(
        W, H, config.qp,
        {k: (p["levels"], p["block_size"]) for k, p in info["planes"].items()},
        {k: p["modes"] for k, p in info["planes"].items()})
    t1 = clock()
    seq._strip_param_sets(bits)
    t2 = clock()
    log(f"[6f] entropy stage of one default-config 1080p frame ({len(bits)} "
        f"bytes): assemble_bitstream {1e3 * (t1 - t0):.2f} ms, "
        f"_strip_param_sets {1e3 * (t2 - t1):.2f} ms (host clock) [{gpu}]")


def sequence_times(dev, tmp: str, src: str, frames: list, closed_bits: str,
                   gpu: str) -> None:
    """6f: 16 1080p 4:2:0 frames, batch 8, under each config (warm):
    throughput as the JAX package counts it (all samples) and luma
    Mpix/s, the Stopwatch stages, whether the next batch was still
    running when drain began and ended, the device busy share
    (torch.profiler); then the drain's event check, the entropy stage's
    split, one run with entropy_tiles=4 and decode_sequence."""
    bits = os.path.join(tmp, "times.bin")
    for label, (config, closed) in SEQ_CONFIGS.items():
        with OverlapProbe() as probe:
            res = run_sequence(dev, src, bits, config, closed)
        tp = res.stats["throughput"]
        stages = ", ".join(f"{k} {v['total_s'] * 1e3:.1f} ms/{v['calls']}"
                           for k, v in res.stats.items() if k != "throughput")
        log(f"[6f] sequence {label}: {tp['seconds'] * 1e3:.1f} ms for 16 "
            f"frames, {tp['mpix_per_s']:.2f} Mpix/s counted as the JAX "
            f"package counts (all samples), "
            f"{SEQ_FRAMES * H * W / tp['seconds'] / 1e6:.2f} Mpix/s luma, "
            f"{1e3 * tp['seconds'] / SEQ_FRAMES:.2f} ms a frame; stages "
            f"(host clock) {stages}; the next batch still running on the card "
            f"when drain began / ended: {probe.next_running} [{gpu}]")
        busy_us, wall_us = device_busy(
            lambda: run_sequence(dev, src, bits, config, closed), repeats=1)
        log(f"[6f] sequence {label} device over one run (torch.profiler): "
            f"{busy_us:.1f} us of kernels and copies in {wall_us:.1f} us: "
            f"{busy_share(busy_us, wall_us)} [{gpu}]")
    drain_waits_on_its_event_only(dev, frames, gpu)
    entropy_split(dev, frames, gpu)
    res = run_sequence(dev, src, bits, EncoderConfig(), False, entropy_tiles=4)
    tp = res.stats["throughput"]
    log(f"[6f] sequence default, entropy_tiles=4: {tp['seconds'] * 1e3:.1f} ms "
        f"for 16 frames ({tp['mpix_per_s']:.2f} Mpix/s all samples), entropy "
        f"{res.stats['entropy']['total_s'] * 1e3:.1f} ms [{gpu}]")
    out = os.path.join(tmp, "times_dec.yuv")
    t0 = time.perf_counter()
    seq.decode_sequence(closed_bits, out, device=dev)
    dec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq.decode_sequence_levels(closed_bits)
    parse_s = time.perf_counter() - t0
    busy_us, wall_us = device_busy(
        lambda: seq.decode_sequence(closed_bits, out, device=dev), repeats=1)
    log(f"[6f] decode_sequence of the 16-frame closed-loop (default) stream: "
        f"{dec_s * 1e3:.1f} ms ({dec_s * 1e3 / SEQ_FRAMES:.2f} ms a frame; "
        f"the decode kernel, host in and out; the plain loop took 3638.2 "
        f"ms on an H100, PERF.md section 5), "
        f"of which the host parse (decode_sequence_levels) "
        f"{parse_s * 1e3:.1f} ms; device over one call (torch.profiler): "
        f"{busy_us:.1f} us of kernels and copies in {wall_us:.1f} us: "
        f"{busy_share(busy_us, wall_us)} [{gpu}]")


# --- the RD stages (7a-7e) ---------------------------------------------------

RD_FRAME_CONFIGS = {
    "rdo_cbf+rdoq": EncoderConfig(rdo_cbf=True, rdoq=True),
    "rdo_cbf+rdoq, mode search": EncoderConfig(
        mode_set="all", decision="satd", rdo_cbf=True, rdoq=True),
    'decision="rd"': EncoderConfig(decision="rd"),
}
RD_CROP_CONFIGS = {
    'mode_set="all", decision="rd" (open loop)': (
        EncoderConfig(mode_set="all", decision="rd"), False),
    "rdoq (closed loop)": (EncoderConfig(rdoq=True), True),
    'decision="rd" (closed loop)': (EncoderConfig(decision="rd"), True),
    'mode_set="all", decision="rd", smoothing, rdoq (closed loop)': (
        EncoderConfig(mode_set="all", decision="rd", intra_smoothing=True,
                      rdoq=True), True),
    'decision="rd", chroma_mode_set="dc" (closed loop)': (
        EncoderConfig(decision="rd", chroma_mode_set="dc"), True),
}
# Results of the non-RD sequence runs (4f, 4g), printed beside 7d's.
SEQ_RESULTS = {}


def crop(frame: Frame, h: int, w: int) -> Frame:
    """The top-left h x w of a 4:2:0 frame (h and w even)."""
    return Frame(Plane(frame.y.data[:h, :w].copy()),
                 Plane(frame.u.data[:h // 2, :w // 2].copy()),
                 Plane(frame.v.data[:h // 2, :w // 2].copy()))


def no_launches(what: str) -> None:
    launches = read_launches()
    if any(launches.values()):
        raise SystemExit(f"{what} launched {launches}; the RD stages run "
                         "on the plain path only")


def wavefront_calls(what: str, calls: int, entries: PlainLoopEntries) -> None:
    """The closed loop under RDOQ: exactly one wavefront launch per
    encode_planes_closed_loop call (`calls` of them since the counts
    were reset), no other kernel, and no plain-loop entry."""
    launches = read_launches()
    want = {k: calls if k == "wavefront_encode_planes" else 0 for k in KERNELS}
    if launches != want or entries.count:
        raise SystemExit(f"{what} launched {launches} with {entries.count} "
                         f"plain-loop entries; expected {want} and none")
    add_scan_launches()


def rd_planes(cfg: EncoderConfig) -> tuple:
    """(RD kernel launches, wavefront launches) of one closed-loop frame
    under decision="rd": a plane batch (Y; U and V) whose mode set is
    decided (dc_planar, all) runs the RD kernel, a fixed mode set the
    wavefront kernel's fixed body."""
    rd = sum(plane_args(cfg, is_luma)["mode_set"] in RD_SETS
             for is_luma in (True, False))
    return rd, FRAME_BATCHES - rd


def rd_calls(what: str, rd: int, wavefront: int,
             entries: PlainLoopEntries) -> None:
    """The closed loop under decision="rd": the RD kernel exactly once
    per encode_planes_closed_loop call of a decided mode set (`rd` since
    the counts were reset), the wavefront kernel `wavefront` times, no
    other kernel, and no plain-loop entry.  Adds the launches to the
    kernels-line rows."""
    launches = read_launches()
    want = {k: rd if k == "wavefront_rd_encode_planes" else
            wavefront if k == "wavefront_encode_planes" else 0
            for k in KERNELS}
    if launches != want or entries.count:
        raise SystemExit(f"{what} launched {launches} with {entries.count} "
                         f"plain-loop entries; expected {want} and none")
    for (mode_set, _, _), count in \
            krd.wavefront_rd_encode_planes.launches_by_config.items():
        RD_LAUNCHES[mode_set] += count
    add_scan_launches()


def closed_rd(what: str, frame: Frame, cfg: EncoderConfig, dev) -> tuple:
    """encode_frame_closed_loop under decision="rd" on the card with
    every count at 0, gated by rd_calls; returns (recon, bytes)."""
    reset_launches()
    with PlainLoopEntries() as entries:
        out = encode_frame_closed_loop(frame, cfg, device=dev)
        torch.cuda.synchronize()
    rd_calls(what, *rd_planes(cfg), entries)
    return out


def phase_rd_open(dev, frame: Frame, gpu: str) -> dict:
    """7a: the open loop's RD stages on the 1080p frame on the card: no
    kernel launch (RD cbf, RDOQ and the RD decision are plain PyTorch),
    recon, levels, modes, nnz and bytes == the port on the CPU; the
    frame call (median of 3) and its device part (3 planes resident)."""
    mpix = H * W / 1e6
    planes = [torch.from_numpy(p.data.astype(np.int32)).to(dev)
              for p in (frame.y, frame.u, frame.v)]
    out = {}
    for label, cfg in RD_FRAME_CONFIGS.items():
        reset_launches()
        t0 = time.perf_counter()
        card = encode_frame_full(frame, cfg, device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        no_launches(f"encode_frame_full ({label})")
        t0 = time.perf_counter()
        cpu = encode_frame_full(frame, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        bits = assemble_frame_bitstream(W, H, cfg, card[1])
        if not same_encode(card, cpu) or bits != assemble_frame_bitstream(
                W, H, cfg, cpu[1]):
            raise SystemExit(f"RD encode ({label}) on the card differs from "
                             "the port on the CPU")
        dev_ms = cuda_ms(lambda: [encode_plane_config(p, cfg, i == 0)
                                  for i, p in enumerate(planes)],
                         iters=3, warmup=1)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            encode_frame_full(frame, cfg, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_ms = 1e3 * sorted(walls)[1]
        log(f"[7a] {label}: 1080p 4:2:0 encode_frame_full on the card == "
            f"the port on the CPU (recon, levels, modes, nnz, {len(bits)} "
            f"bytes; Y-PSNR {card[1]['psnr_y']:.2f} dB; first call "
            f"{first_s:.2f} s, CPU {cpu_s:.2f} s); frame call {wall_ms:.2f} "
            f"ms (median of 3, {mpix / wall_ms * 1e3:.2f} Mpix/s luma), "
            f"device part {dev_ms:.2f} ms [{gpu}]")
        out[label] = bits
    return out


def phase_rd_crops(dev, frame: Frame, gpu: str) -> None:
    """7b: the 35-mode RD decision (open loop, no kernel launch) and the
    closed loop with RDOQ (the wavefront kernel, one launch a plane
    batch: Y, then U and V) and with decision="rd" (DC/planar; the 35
    modes with smoothing and RDOQ; a fixed chroma mode set: the RD kernel
    once a decided plane batch, the wavefront kernel's fixed body once a
    fixed one) on a 256x256 crop and
    a 138x250 one (not block-aligned): card == CPU, bytes and recon; the
    closed loop's streams decode on the card to their recon."""
    for h, w in ((256, 256), (138, 250)):
        small = crop(frame, h, w)
        for label, (cfg, closed) in RD_CROP_CONFIGS.items():
            reset_launches()
            t0 = time.perf_counter()
            if closed:
                if cfg.decision == "rd":
                    card = closed_rd(f"[7b] {label}", small, cfg, dev)
                else:
                    with PlainLoopEntries() as entries:
                        card = encode_frame_closed_loop(small, cfg,
                                                        device=dev)
                        torch.cuda.synchronize()
                    wavefront_calls(label, FRAME_BATCHES, entries)
                card_s = time.perf_counter() - t0
                cpu = encode_frame_closed_loop(small, cfg, device="cpu")
                decoded = counted_decode(
                    f"[7b] {label} decode_frame", 3,
                    lambda: decode_frame(card[1], device=dev))
                same = card[1] == cpu[1] and same_frames(card[0], cpu[0]) \
                    and same_frames(decoded, card[0])
                size = len(card[1])
            else:
                card = encode_frame_full(small, cfg, device=dev)
                torch.cuda.synchronize()
                card_s = time.perf_counter() - t0
                cpu = encode_frame_full(small, cfg, device="cpu")
                size = len(assemble_frame_bitstream(w, h, cfg, card[1]))
                same = same_encode(card, cpu) and size == len(
                    assemble_frame_bitstream(w, h, cfg, cpu[1]))
                no_launches(label)
            if not same:
                raise SystemExit(f"{label} on a {h}x{w} crop: the card "
                                 "differs from the CPU")
            log(f"[7b] {label}, {h}x{w} crop: card == CPU ({size} bytes; "
                f"{card_s:.2f} s on the card) [{gpu}]")


def phase_rd_closed_full(dev, frame: Frame, gpu: str) -> None:
    """7c: the closed loop with RDOQ (the wavefront kernel, one launch a
    plane batch) and with decision="rd" (the RD kernel, one launch a plane
    batch: Y, then U and V) on
    the 1080p frame on the card, no plain-loop entry; recon and bytes ==
    the port on the CPU; each stream decodes on the card to the recon
    pixel for pixel; the frame call, first and warm (median of 3)."""
    for label, cfg in (("rdoq", EncoderConfig(rdoq=True)),
                       ('decision="rd"', EncoderConfig(decision="rd"))):
        t0 = time.perf_counter()
        if cfg.decision == "rd":
            recon, bits = closed_rd(f"[7c] closed loop ({label})", frame,
                                    cfg, dev)
        else:
            reset_launches()
            with PlainLoopEntries() as entries:
                recon, bits = encode_frame_closed_loop(frame, cfg,
                                                       device=dev)
                torch.cuda.synchronize()
            wavefront_calls(f"closed loop ({label})", FRAME_BATCHES,
                            entries)
        enc_s = time.perf_counter() - t0
        # the kernel's frame == the plain loop's on the CPU
        t0 = time.perf_counter()
        cpu = encode_frame_closed_loop(frame, cfg, device="cpu")
        if cpu[1] != bits or not same_frames(cpu[0], recon):
            raise SystemExit(f"closed loop ({label}): the card differs "
                             "from the CPU")
        cpu_s = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            encode_frame_closed_loop(frame, cfg, device=dev)
            walls.append(time.perf_counter() - t0)
        warm = (f", == the CPU in recon and bytes (CPU {cpu_s:.1f} s), "
                f"warm frame call {1e3 * sorted(walls)[1]:.2f} ms (median "
                f"of 3)")
        t0 = time.perf_counter()
        decoded = counted_decode(f"[7c] {label} decode_frame", 3,
                                 lambda: decode_frame(bits, device=dev))
        dec_s = time.perf_counter() - t0
        if not all(np.array_equal(getattr(recon, p).data,
                                  getattr(decoded, p).data) for p in "yuv"):
            raise SystemExit(f"closed loop ({label}): decode_frame differs "
                             "from the recon")
        y_psnr = oracle.psnr(frame.y.data.astype(np.uint8),
                             recon.y.data.astype(np.uint8))
        log(f"[7c] closed loop {label}, 1080p 4:2:0 on the card: "
            f"{len(bits)} bytes, Y-PSNR {y_psnr:.2f} dB, encode "
            f"{enc_s:.3f} s (first call){warm}, decode_frame {dec_s:.2f} s, "
            f"decoded == recon pixel for pixel [{gpu}]")


def phase_rd_sequences(dev, tmp: str, src: str, frames: list,
                       gpu: str) -> dict:
    """7d: encode_sequence of the 16-frame 1080p file at batch 8 with
    rdo_cbf+rdoq (open loop, no kernel launch), rdoq (closed loop: the
    wavefront kernel once a batch's luma and once its chroma stack, one
    launch a plane in the single-frame encodes) and decision="rd"
    (closed loop: the RD kernel alike), no plain-loop entry: every frame
    parses back to its single-frame encode on the card; bytes and mean
    Y-PSNR beside the same runs without RD (4f, 4g)."""
    out = {}
    for label, cfg, closed, base in (
            ("open loop, rdo_cbf+rdoq", EncoderConfig(rdo_cbf=True, rdoq=True),
             False, "default"),
            ("closed loop, rdoq", EncoderConfig(rdoq=True), True,
             "closed loop default"),
            ('closed loop, decision="rd"', EncoderConfig(decision="rd"), True,
             "closed loop default")):
        rd = cfg.decision == "rd"
        bits = os.path.join(tmp, f"rd_{len(out)}.bin")
        reset_launches()
        t0 = time.perf_counter()
        with PlainLoopEntries() as entries:
            res = run_sequence(dev, src, bits, cfg, closed)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        batch_calls = 2 * -(-SEQ_FRAMES // SEQ_BATCH)
        if rd:          # one launch a batch's luma, one its chroma stack
            rd_calls(f"sequence ({label})", batch_calls, 0, entries)
        elif closed:
            wavefront_calls(f"sequence ({label})", batch_calls, entries)
        else:
            no_launches(f"sequence ({label})")
        parsed = seq.decode_sequence_levels(bits)
        reset_launches()
        t1 = time.perf_counter()
        with PlainLoopEntries() as entries:
            for i, fr in enumerate(frames):
                if closed:
                    want = parse_bitstream(encode_frame_closed_loop(
                        fr, cfg, device=dev)[1])
                else:
                    want = encode_frame_full(fr, cfg, device=dev)[1]["planes"]
                if not same_planes(parsed[i], want):
                    raise SystemExit(f"RD sequence ({label}) frame {i} "
                                     "differs from its single-frame encode")
        frames_s = time.perf_counter() - t1
        if rd:
            rd_calls(f"single-frame encodes ({label})",
                     FRAME_BATCHES * len(frames), 0, entries)
        elif closed:
            wavefront_calls(f"single-frame encodes ({label})",
                            FRAME_BATCHES * len(frames), entries)
        else:
            no_launches(f"single-frame encodes ({label})")
        plain = SEQ_RESULTS[base]
        log(f"[7d] encode_sequence {label}, 16 1080p frames, batch 8: "
            f"{run_s:.3f} s, {res.bytes_written} bytes, mean Y-PSNR "
            f"{res.mean_psnr_y:.2f} dB; without RD {plain.bytes_written} "
            f"bytes, {plain.mean_psnr_y:.2f} dB; each frame == its "
            f"single-frame encode ({len(frames)} of them in {frames_s:.2f} "
            f"s) [{gpu}]")
        out[label] = bits
    return out


def phase_rd(dev, tmp: str, src: str, frame: Frame, frames: list,
             gpu: str) -> None:
    """7: the RD stages (7a-7d), then 7e: the CLI's `encode --rdo --rdoq`
    and `encode --decision rd` write the API's bytes."""
    t0 = time.perf_counter()
    bits = phase_rd_open(dev, frame, gpu)
    phase_rd_crops(dev, frame, gpu)
    phase_rd_closed_full(dev, frame, gpu)
    phase_rd_sequences(dev, tmp, src, frames, gpu)
    phase_cli(frame, bits["rdo_cbf+rdoq"], ["--rdo", "--rdoq"], "7e")
    phase_cli(frame, bits['decision="rd"'], ["--decision", "rd"], "7e")
    log(f"[7] RD phase: {time.perf_counter() - t0:.1f} s [{gpu}]")


# --- the loop filters' kernels (3i, 6i; launches on 8a-8c and 9b) -----------

# name -> (wrapper, source, what it replaces: JAX's XLA filter stage)
FILTER_KERNELS = {
    "deblock_planes": (
        lf.deblock_planes, "nanohevc_tpu_torch/csrc/deblock.cu",
        "nanohevc_tpu/ops/deblock.py:159 (deblock_plane, XLA ops called by "
        "nanohevc_tpu/models/wavefront.py:431-475 and :784-806; no Pallas "
        "kernel)"),
    "sao_estimate": (
        lf.sao_estimate, "nanohevc_tpu_torch/csrc/sao.cu",
        "nanohevc_tpu/ops/sao_ctb.py:76,144 (sao_tile_stats, "
        "estimate_sao_ctb's 34 candidates and merge pass) and "
        "nanohevc_tpu/ops/sao.py:111 (estimate_sao), XLA ops called by "
        "nanohevc_tpu/models/wavefront.py:431-475; no Pallas kernel"),
    "sao_apply": (
        lf.sao_apply, "nanohevc_tpu_torch/csrc/sao.cu",
        "nanohevc_tpu/ops/sao_ctb.py:232 (apply_sao_ctb) and "
        "nanohevc_tpu/ops/sao.py:73 (apply_sao), XLA ops called by "
        "nanohevc_tpu/models/wavefront.py:431-475 and :784-806; no Pallas "
        "kernel"),
}
# Main-path launches of each (8a-8c, 9b), added by check_filters.
FILTER_LAUNCHES = dict.fromkeys(FILTER_KERNELS, 0)
SAO_TILES = (16, 32, 64, 128)


def filter_counts() -> dict:
    return {name: FILTER_KERNELS[name][0].launches for name in FILTER_KERNELS}


def filter_want(cfg: EncoderConfig, calls: int, encode: bool = True) -> dict:
    """Filter launches of `calls` plane-batch calls under cfg: deblocking
    once a call where cfg deblocks; SAO's application once a call, and
    on an encode its estimate once, where cfg has per-frame or CTB SAO."""
    sao = cfg.sao or cfg.sao_ctb
    return {"deblock_planes": calls * cfg.deblock,
            "sao_estimate": calls * (sao and encode),
            "sao_apply": calls * sao}


def check_filters(what: str, want: dict) -> None:
    """The filter kernels launched exactly `want` since the counts were
    reset (on the card: no plain filter ran); adds them to the main-path
    counts."""
    torch.cuda.synchronize()
    got = filter_counts()
    if got != want:
        raise SystemExit(f"{what}: filter launches {got}, expected {want}")
    for name, n in got.items():
        FILTER_LAUNCHES[name] += n


def blocky_planes(batch: int, h: int, w: int, bit_depth: int, rng, dev):
    """(src, rec) (batch, h, w) int32 on the card: textured sources, and
    reconstructions made of 8x8 block means blended with the source,
    shifted in a band of levels and noised, so that deblocking meets
    every edge strength and every SAO candidate family wins somewhere."""
    peak = (1 << bit_depth) - 1
    src = np.stack([textured(h, w, bit_depth, rng) for _ in range(batch)])
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    padded = np.pad(src, ((0, 0), (0, hp - h), (0, wp - w)), mode="edge")
    means = padded.reshape(batch, hp // 8, 8, wp // 8, 8).mean(axis=(2, 4))
    blocks = np.repeat(np.repeat(means, 8, 1), 8, 2)[:, :h, :w]
    rec = (3 * blocks + src) / 4
    band = (src >> (bit_depth - 5)) % 6 == 1
    rec = rec + np.where(band, 3 << (bit_depth - 8), 0)
    rec = rec + rng.integers(-2, 3, src.shape) * (1 << (bit_depth - 8))
    rec = np.clip(np.rint(rec), 0, peak).astype(np.int32)
    return (torch.from_numpy(src.astype(np.int32)).to(dev),
            torch.from_numpy(rec).to(dev))


def filter_planes(dev, frame: Frame) -> list:
    """(label, src, rec, chroma) of the three padded 1080p planes of the
    default config's closed-loop recon (the wavefront kernel's output,
    before any filter)."""
    config = EncoderConfig()
    out = []
    for name, p in (("Y", frame.y), ("U", frame.u), ("V", frame.v)):
        args = plane_args(config, name == "Y")
        src = pad_to_blocks(torch.from_numpy(p.data.astype(np.int32))[None]
                            .to(dev), args["n"])
        rec = encode_planes_closed_loop(src, config.qp, **args)["recon"]
        out.append((name, src, rec, name != "Y"))
    return out


def differing(got, want) -> int:
    """Largest |difference| over a kernel's outputs and its plain
    version's (tuples or tensors); raises where shapes or types differ."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SystemExit(f"3i: kernel output {tuple(g.shape)} {g.dtype} "
                             f"!= plain {tuple(w.shape)} {w.dtype}")
        if g.numel():
            worst = max(worst, int((g.long() - w.long()).abs().max()))
    return worst


def sao_plain(src, rec, bit_depth: int, tile=None, qp: int = 22,
              merge: bool = True) -> tuple:
    """The plain versions of `lf.sao_estimate(..., return_stats=True)`:
    (parameters, statistics)."""
    if tile is None:
        params = ops_sao.estimate_sao(src, rec, bit_depth)
    else:
        params = ops_ctb.estimate_sao_ctb(src, rec, tile, qp, bit_depth,
                                          merge=merge)
    return params, lf.sao_statistics_reference(
        src, rec, lf.FRAME_STATS_TILE if tile is None else tile, bit_depth)


def estimate_repeats(pairs, bit_depth: int, hold) -> None:
    """The estimate needs no reset between launches: per-plane SAO, CTB
    SAO at tiles of 64 and, merge on, 16: two launches back to back on
    the two (src, rec) pairs (no synchronise between them), then three
    replays of a CUDA graph captured on static copies, the pairs copied
    in as A, B, A; every output == plain."""
    (src_a, rec_a), (src_b, rec_b) = pairs
    for kw in (dict(), dict(tile=64, qp=22, merge=False),
               dict(tile=16, qp=37, merge=True)):
        what = f"{tuple(rec_a.shape)}, {kw or 'per-plane'}"
        first = lf.sao_estimate(src_a, rec_a, bit_depth=bit_depth,
                                return_stats=True, **kw)
        second = lf.sao_estimate(src_b, rec_b, bit_depth=bit_depth,
                                 return_stats=True, **kw)
        hold("sao_estimate", first[0] + (first[1],), unpack(sao_plain(
            src_a, rec_a, bit_depth, **kw)), f"{what}, launch 1 of 2")
        hold("sao_estimate", second[0] + (second[1],), unpack(sao_plain(
            src_b, rec_b, bit_depth, **kw)), f"{what}, launch 2 of 2")
        static_src, static_rec = src_a.clone(), rec_a.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = lf.sao_estimate(static_src, static_rec, bit_depth=bit_depth,
                                  return_stats=True, **kw)
        for k, (src, rec) in enumerate(((src_a, rec_a), (src_b, rec_b),
                                        (src_a, rec_a))):
            static_src.copy_(src)
            static_rec.copy_(rec)
            graph.replay()
            hold("sao_estimate", out[0] + (out[1],), unpack(sao_plain(
                src, rec, bit_depth, **kw)), f"{what}, graph replay {k + 1}")


def unpack(result: tuple) -> tuple:
    """(parameters, statistics) -> parameters + (statistics,)."""
    return result[0] + (result[1],)


def phase_filters_vs_plain(dev, frame: Frame, gpu: str) -> dict:
    """3i: each filter kernel == its plain version on the card, with no
    tolerance: the three padded 1080p planes of the default closed-loop
    recon, a 138x250 crop (unpadded: tails and partial tiles; 138 rows
    are no multiple of 4) at 8 and 10 bits, a 45x200 pair, and a batch
    of 8 540x960 planes; deblocking luma and chroma at an int QP and at
    a (B,) QP tensor of two values; the SAO estimate, its statistics and
    parameters (per-plane SAO, and CTB SAO at tiles 16, 32, 64 and 128
    with merge on and off) against `ops` end to end, launched back to
    back and replayed in a CUDA graph with no reset between; the
    application of the chosen parameters and of seeded maps of every
    type and band position.  Returns the worst |difference| by kernel
    (0 or the phase fails)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    cases = [(f"1080p {name}", src, rec, 8, chroma)
             for name, src, rec, chroma in filter_planes(dev, frame)]
    for h, w, bd, b in ((138, 250, 8, 1), (138, 250, 10, 2), (45, 200, 8, 2),
                        (540, 960, 8, 8)):
        src, rec = blocky_planes(b, h, w, bd, rng, dev)
        for chroma in (False, True):
            cases.append((f"{b}x{h}x{w} {bd}-bit", src, rec, bd, chroma))
    worst = dict.fromkeys(FILTER_KERNELS, 0)
    checks = 0

    def hold(name, got, want, what):
        nonlocal checks
        err = differing(got, want)
        if err:
            raise SystemExit(f"3i: {name} != plain on {what} (max |diff| "
                             f"{err}) [{gpu}]")
        worst[name] = max(worst[name], err)
        checks += 1

    for label, src, rec, bd, chroma in cases:
        b = rec.shape[0]
        qps = [22] if b == 1 else [22, 37] * (b // 2)
        kind = "chroma" if chroma else "luma"
        for qp in (37, torch.tensor(qps, device=dev)):
            what = f"{label}, {kind}, QP {qp if isinstance(qp, int) else qps}"
            hold("deblock_planes", lf.deblock_planes(rec, qp, bd, chroma),
                 ops.deblock_plane(rec, qp, bd, chroma), what)
        deb = lf.deblock_planes(rec, 22, bd, chroma)
        if chroma and not label.startswith("1080p"):
            continue      # SAO does not depend on the deblocking filter
        params, stats = lf.sao_estimate(src, deb, bit_depth=bd,
                                        return_stats=True)
        hold("sao_estimate", params + (stats,),
             unpack(sao_plain(src, deb, bd)), f"{label}, per-plane SAO")
        hold("sao_apply", lf.sao_apply(deb, *params, bit_depth=bd),
             ops_sao.apply_sao(deb, *params, bd), f"{label}, apply_sao")
        for tile in SAO_TILES:
            for merge in (True, False):
                what = f"{label}, tile {tile}, merge {merge}"
                maps, stats = lf.sao_estimate(
                    src, deb, tile=tile, qp=22, bit_depth=bd, merge=merge,
                    return_stats=True)
                hold("sao_estimate", maps + (stats,), unpack(sao_plain(
                    src, deb, bd, tile, 22, merge)), what)
                hold("sao_apply", lf.sao_apply(deb, *maps, tile, bd),
                     ops_ctb.apply_sao_ctb(deb, *maps, tile, bd), what)
            cap = (1 << (min(bd, 10) - 5)) - 1
            seeded = tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (
                rng.integers(0, 6, maps[0].shape),
                rng.integers(0, 32, maps[0].shape),
                rng.integers(-cap, cap + 1, maps[2].shape)))
            hold("sao_apply", lf.sao_apply(deb, *seeded, tile, bd),
                 ops_ctb.apply_sao_ctb(deb, *seeded, tile, bd),
                 f"{label}, tile {tile}, seeded maps")
    luma = cases[0]
    estimate_repeats([(luma[1], luma[2]), (luma[2], luma[1])], 8, hold)
    batch = next(c for c in cases if c[0].startswith("8x540x960"))
    estimate_repeats([(batch[1], batch[2]), (batch[2], batch[1])], 8, hold)
    torch.cuda.synchronize()
    log(f"[3i] loop-filter kernels == plain on the card, 0 samples, maps, "
        f"offsets or statistics differing: {checks} checks over "
        f"{len(cases)} cases (1080p Y/U/V of the closed-loop recon; 138x250 "
        f"at 8 and 10 bits, 45x200, a batch of 8 540x960; luma and chroma "
        f"deblocking at an int QP and a (B,) QP tensor; the SAO estimate's "
        f"statistics and parameters, per-plane SAO, CTB SAO at tiles "
        f"{'/'.join(map(str, SAO_TILES))} with merge on and off, two "
        f"launches back to back and three CUDA-graph replays with no reset "
        f"between on the 1080p luma plane and the 540x960 batch; seeded "
        f"maps of every type) ({time.perf_counter() - t0:.1f} s) [{gpu}]")
    return worst


# Integer operations a sample (upper estimates; every kernel is bound by
# its bytes at these counts): deblocking's two passes (a segment's
# decision and filters over the 8 samples of an edge), the estimate's
# four classifications and band, the application's one classification.
FILTER_OPS = {"deblock_planes": 18, "sao_estimate": 45, "sao_apply": 12}
# Float32 operations a tile of the estimate's decision: 48 offsets and
# deltas, 34 scores and their minimum, two merge candidates.
DECIDE_OPS = 600


def filter_bound(name: str, planes: int, pixels: int, tiles: int) -> tuple:
    """(bound ms, "bytes" or "operations") of a filter kernel on `planes`
    planes of `pixels` samples and `tiles` SAO tiles each: int32 samples
    read and written once each (the estimate reads src and rec and
    writes 96 ints of statistics and 6 of parameters a tile; the
    application reads a plane and the maps and writes a plane),
    operations at 67 T/s."""
    nbytes = planes * pixels * 8
    ops_n = planes * pixels * FILTER_OPS[name]
    if name == "sao_estimate":
        nbytes += planes * tiles * 4 * (lf.STAT_INTS + 6)
        ops_n += planes * tiles * DECIDE_OPS
    if name == "sao_apply":
        nbytes += planes * tiles * 4 * 6
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = ops_n / 67e12 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def filter_times(dev, frame: Frame, gpu: str) -> dict:
    """6i: each filter kernel and its plain version on the card a padded
    1080p plane (Y, U, V of the default config's closed-loop recon; CTB
    SAO at the default tile of 64, merge on; the per-plane estimate
    beside it), through a CUDA graph, beside the bound.  Returns
    {kernel: (ms, plain ms)} on the luma plane."""
    out = {}
    for name, src, rec, chroma in filter_planes(dev, frame):
        tile = 64
        deb = lf.deblock_planes(rec, 22, 8, chroma)
        maps = lf.sao_estimate(src, deb, tile=tile, qp=22)
        fns = {
            "deblock_planes": (lambda: lf.deblock_planes(rec, 22, 8, chroma),
                               lambda: ops.deblock_plane(rec, 22, 8, chroma)),
            "sao_estimate": (
                lambda: lf.sao_estimate(src, deb, tile=tile, qp=22),
                lambda: ops_ctb.estimate_sao_ctb(src, deb, tile, 22)),
            "sao_estimate (per-plane)": (
                lambda: lf.sao_estimate(src, deb),
                lambda: ops_sao.estimate_sao(src, deb)),
            "sao_apply": (lambda: lf.sao_apply(deb, *maps, tile),
                          lambda: ops_ctb.apply_sao_ctb(deb, *maps, tile)),
        }
        h, w = rec.shape[1:]
        tiles = -(-h // tile) * -(-w // tile)
        parts = []
        for kern, (k_fn, p_fn) in fns.items():
            k_ms, p_ms = graph_ms(k_fn), graph_ms(p_fn, iters=5)
            bound, by = filter_bound(kern.split(" ")[0], 1, h * w, tiles)
            parts.append(f"{kern} {k_ms:.4f} (plain {p_ms:.4f}, bound "
                         f"{bound * 1e3:.2f} us {by}, {100 * bound / k_ms:.1f} %)")
            if name == "Y" and kern in FILTER_KERNELS:
                out[kern] = (k_ms, p_ms)
        log(f"[6i] {name} {h}x{w}, ms (CUDA graph): {'; '.join(parts)} "
            f"[{gpu}]")
    return out


# --- the loop filters and the standard export (8a-8d) -----------------------

FILTER_CONFIGS = {
    "deblock": dict(deblock=True),
    "sao": dict(sao=True),
    "sao_ctb (tile 32)": dict(sao_ctb=True, sao_tile=32),
    "sao_ctb (tile 64)": dict(sao_ctb=True),
    "deblock+sao": dict(deblock=True, sao=True),
    "deblock+sao_ctb": dict(deblock=True, sao_ctb=True),
}


def filtered(base: EncoderConfig, **kw) -> EncoderConfig:
    return dataclasses.replace(base, **kw)


def same_frames(a: Frame, b: Frame) -> bool:
    return all(np.array_equal(getattr(a, p).data, getattr(b, p).data)
               for p in "yuv")


def same_sao(a: dict, b: dict) -> bool:
    """The per-plane SAO and CTB-SAO parameters of two parsed frames."""
    pa, pb = a.get("params", {}), b.get("params", {})
    for kind in ("sao", "sao_ctb"):
        da, db = pa.get(kind) or {}, pb.get(kind) or {}
        if da.keys() != db.keys() or not all(
                np.array_equal(np.asarray(x), np.asarray(y))
                for k in da for x, y in zip(da[k], db[k])):
            return False
    return True


def ten_bit(frame: Frame, rng) -> Frame:
    """The 8-bit frame scaled to 10 bits with noise in the low bits."""
    return Frame(*(Plane(np.clip(p.data.astype(np.int32) * 4
                                 + rng.integers(0, 4, p.data.shape), 0, 1023)
                         .astype(np.int16)) for p in (frame.y, frame.u, frame.v)))


def phase_filters_crops(dev, frame: Frame, gpu: str) -> None:
    """8a: the closed loop with each filter config, on a 256x256 and a
    138x250 crop, under the default config and the mode search, and at
    10 bits (deblock+sao_ctb); with RDOQ and decision="rd"
    (deblock+sao_ctb) on the 138x250 crop: card == CPU in recon and
    bytes (levels, modes and every SAO parameter ride the bytes)."""
    t0 = time.perf_counter()
    cases = []
    for h, w in ((256, 256), (138, 250)):
        small = crop(frame, h, w)
        for base_label, base in (("default", EncoderConfig()),
                                 ("mode search", MODE_SEARCH)):
            for label, kw in FILTER_CONFIGS.items():
                cases.append((f"{label}, {base_label}", small,
                              filtered(base, **kw)))
        cases.append(("deblock+sao_ctb, 10-bit", ten_bit(small, np.random
                                                         .default_rng(h)),
                      EncoderConfig(deblock=True, sao_ctb=True, bit_depth=10)))
    # The RD routes (seconds a crop on each device) on the unaligned crop.
    unaligned = crop(frame, 138, 250)
    cases.append(("deblock+sao_ctb, rdoq", unaligned,
                  EncoderConfig(deblock=True, sao_ctb=True, rdoq=True)))
    cases.append(('deblock+sao_ctb, decision="rd"', unaligned,
                  EncoderConfig(deblock=True, sao_ctb=True, decision="rd")))
    sizes = {}
    for label, small, cfg in cases:
        if cfg.decision == "rd":
            card = closed_rd(f"[8a] {label}", small, cfg, dev)
        else:
            reset_launches()
            card = encode_frame_closed_loop(small, cfg, device=dev)
        check_filters(f"[8a] {label}", filter_want(cfg, FRAME_BATCHES))
        cpu = encode_frame_closed_loop(small, cfg, device="cpu")
        if card[1] != cpu[1] or not same_frames(card[0], cpu[0]):
            raise SystemExit(f"8a: {label} on a {small.height}x{small.width} "
                             "crop: the card differs from the CPU")
        decoded = counted_decode(f"[8a] {label} decode_frame", 3,
                                 lambda: decode_frame(card[1], device=dev),
                                 cfg)
        if not same_frames(decoded, card[0]):
            raise SystemExit(f"8a: {label}: decode_frame != recon")
        sizes.setdefault(small.height, []).append(len(card[1]))
    log(f"[8a] {len(cases)} filtered closed-loop encodes (6 filter configs x "
        f"default and mode search, 10-bit; 256x256 and 138x250 crops; RDOQ "
        f"and decision=\"rd\" on the 138x250 crop): card == CPU in recon "
        f"and bytes, the filter kernels once a plane batch each (no plain "
        f"filter "
        f"on the card), each stream decoded on the card to its recon; bytes "
        f"256x256 "
        f"{min(sizes[256])}-{max(sizes[256])}, 138x250 "
        f"{min(sizes[138])}-{max(sizes[138])} "
        f"({time.perf_counter() - t0:.1f} s) [{gpu}]")


def filter_stage_times(dev, frame: Frame, gpu: str) -> None:
    """Each filter stage a padded 1080p plane (Y, U, V of the default
    config's closed-loop recon), the kernels' wrappers beside the plain
    ops on the same card: the stream's time a call between CUDA events
    over 10 back-to-back calls (host dispatch gaps included), and the
    device time a call through a CUDA graph (`graph_ms`)."""
    parts = []
    for name, src, rec, chroma in filter_planes(dev, frame):
        sao_params = ops_sao.estimate_sao(src, rec)
        maps = ops_ctb.estimate_sao_ctb(src, rec, 64, 22)
        stages = {
            "deblock": (lambda: lf.deblock_planes(rec, 22, 8, chroma),
                        lambda: ops.deblock_plane(rec, 22, 8, chroma)),
            "sao estimate": (lambda: lf.sao_estimate(src, rec),
                             lambda: ops_sao.estimate_sao(src, rec)),
            "sao apply": (lambda: lf.sao_apply(rec, *sao_params),
                          lambda: ops_sao.apply_sao(rec, *sao_params)),
            "ctb estimate": (
                lambda: lf.sao_estimate(src, rec, tile=64, qp=22),
                lambda: ops_ctb.estimate_sao_ctb(src, rec, 64, 22)),
            "ctb apply": (lambda: lf.sao_apply(rec, *maps, 64),
                          lambda: ops_ctb.apply_sao_ctb(rec, *maps, 64)),
        }
        parts.append(f"{name} {tuple(src.shape[1:])}: " + ", ".join(
            f"{k} {cuda_ms(kf, 10):.4f} / {graph_ms(kf, 5):.4f} (plain "
            f"{cuda_ms(pf, 10):.3f} / {graph_ms(pf, 5):.3f})"
            for k, (kf, pf) in stages.items()))
    log("[8b] filter stages a padded plane, ms a call, kernels (plain ops "
        "on the card), stream (CUDA events over 10 calls) / device (CUDA "
        "graph of 5 calls, median of 5 replays): "
        f"{'; '.join(parts)} [{gpu}]")


def frame_call_ms(dev, frame: Frame, cfg: EncoderConfig) -> tuple:
    """The closed-loop frame call (median of 3 after the first) and its
    device part: its two plane-batch calls (Y, then U and V) between
    CUDA events, host dispatch gaps included (5 calls after 1
    warm-up)."""
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode_frame_closed_loop(frame, cfg, device=dev)
        walls.append(time.perf_counter() - t0)
    batches = frame_batches(frame, dev)
    dev_ms = cuda_ms(lambda: [encode_planes_closed_loop(
        p, cfg.qp, **plane_args(cfg, luma)) for p, luma in batches],
        iters=5, warmup=1)
    return 1e3 * sorted(walls)[1], dev_ms


def phase_filters_frame(dev, frame: Frame, base_bits: dict,
                        gpu: str) -> dict:
    """8b: the 1080p frame under the default config and the mode search,
    with deblock+sao and deblock+sao_ctb: the wavefront kernel and each
    filter kernel launch once a plane batch (Y, then U and V) and no other
    kernel launches (the
    filters three launches a plane batch); the stream decodes on the
    card to the recon; bytes and Y-PSNR beside the unfiltered encode;
    the frame call and its device part, the unfiltered encode's timed in
    the same run beside them.  Returns the wavefront launches by body
    and the deblock+sao_ctb stream."""
    launches = {"dc_planar": 0, "search": 0}
    out = {}
    mpix = H * W / 1e6
    for base_label, base in (("default", EncoderConfig()),
                             ("mode search", MODE_SEARCH)):
        body = "dc_planar" if base.mode_set == "dc_planar" else "search"
        plain_bits, plain_recon = base_bits[base_label]
        plain_psnr = oracle.psnr(frame.y.data.astype(np.uint8),
                                 plain_recon.y.data.astype(np.uint8))
        plain_wall, plain_dev = frame_call_ms(dev, frame, base)
        log(f"[8b] no filter, {base_label}, 1080p 4:2:0 closed loop on the "
            f"card: frame call {plain_wall:.2f} ms (median of 3), device "
            f"part {plain_dev:.2f} ms [{gpu}]")
        for label in ("deblock+sao", "deblock+sao_ctb"):
            cfg = filtered(base, **FILTER_CONFIGS[label])
            reset_launches()
            recon, bits = encode_frame_closed_loop(frame, cfg, device=dev)
            torch.cuda.synchronize()
            got = read_launches()
            want = {k: FRAME_BATCHES if k == "wavefront_encode_planes"
                    else 0 for k in KERNELS}
            if got != want:
                raise SystemExit(f"8b: {label}, {base_label} launched {got}, "
                                 f"expected {want}")
            check_filters(f"[8b] {label}, {base_label}",
                          filter_want(cfg, FRAME_BATCHES))
            launches[body] += got["wavefront_encode_planes"]
            t0 = time.perf_counter()
            decoded = counted_decode(f"[8b] {label}, {base_label} "
                                     "decode_frame", 3,
                                     lambda: decode_frame(bits, device=dev),
                                     cfg)
            dec_s = time.perf_counter() - t0
            if not same_frames(decoded, recon):
                raise SystemExit(f"8b: {label}, {base_label}: decode_frame "
                                 "on the card != recon")
            wall_ms, dev_ms = frame_call_ms(dev, frame, cfg)
            psnr = oracle.psnr(frame.y.data.astype(np.uint8),
                               recon.y.data.astype(np.uint8))
            log(f"[8b] {label}, {base_label}, 1080p 4:2:0 closed loop on the "
                f"card: wavefront kernel {FRAME_BATCHES} launches, filter "
                f"kernels {filter_want(cfg, FRAME_BATCHES)}, no other kernel; "
                f"{len(bits)} bytes, Y-PSNR {psnr:.2f} dB (unfiltered "
                f"{len(plain_bits)} bytes, {plain_psnr:.2f} dB); decode_frame "
                f"on the card == recon ({dec_s:.2f} s); frame call "
                f"{wall_ms:.2f} ms (median of 3, {mpix / wall_ms * 1e3:.2f} "
                f"Mpix/s luma; unfiltered {plain_wall:.2f}), device part "
                f"{dev_ms:.2f} ms (unfiltered {plain_dev:.2f}) [{gpu}]")
            out[label, base_label] = (bits, recon)
    filter_stage_times(dev, frame, gpu)
    return launches, out


def phase_filters_sequence(dev, tmp: str, src: str, frames: list,
                           gpu: str) -> int:
    """8c: encode_sequence of the 16-frame 1080p file at batch 8, closed
    loop, with deblock+sao_ctb, and with deblock+sao under target_bpp:
    each frame == its single-frame encode (at its slice QP: levels,
    modes and SAO parameters), and decode_sequence on the card == the
    single-frame recons.  Returns the wavefront kernel's launches."""
    total = 0
    for label, cfg, kw in (
            ("deblock+sao_ctb", EncoderConfig(deblock=True, sao_ctb=True), {}),
            ("deblock+sao, target_bpp 1.0",
             EncoderConfig(deblock=True, sao=True), dict(target_bpp=1.0))):
        bits = os.path.join(tmp, f"filters_{len(kw)}.bin")
        reset_launches()
        t0 = time.perf_counter()
        res = run_sequence(dev, src, bits, cfg, True, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        got = read_launches()
        batches = -(-SEQ_FRAMES // SEQ_BATCH)
        if got != {k: 2 * batches if k == "wavefront_encode_planes" else 0
                   for k in KERNELS}:
            raise SystemExit(f"8c: sequence {label} launched {got}")
        check_filters(f"[8c] sequence {label}", filter_want(cfg, 2 * batches))
        total += got["wavefront_encode_planes"]
        parsed = seq.decode_sequence_levels(bits)
        recon, qps = [], []
        for i, fr in enumerate(frames):
            qp = parsed[i]["Y"].get("qp", cfg.qp)
            qps.append(qp)
            rec, fbits = encode_frame_closed_loop(fr, filtered(cfg, qp=qp),
                                                  device=dev)
            single = parse_bitstream(fbits)
            if not (same_planes(parsed[i], single)
                    and same_sao(parsed[i], single)):
                raise SystemExit(f"8c: sequence {label} frame {i} differs "
                                 "from its single-frame encode")
            recon.append(rec.to_yuv420p())
        dec = os.path.join(tmp, "filters_dec.yuv")
        t0 = time.perf_counter()
        n = counted_decode(f"[8c] {label} decode_sequence",
                           sequence_decodes(SEQ_FRAMES),
                           lambda: seq.decode_sequence(bits, dec, device=dev),
                           cfg)
        dec_s = time.perf_counter() - t0
        with open(dec, "rb") as f:
            if n != SEQ_FRAMES or f.read() != b"".join(recon):
                raise SystemExit(f"8c: decode_sequence ({label}) != recon")
        log(f"[8c] encode_sequence {label}, 16 1080p frames, batch 8, "
            f"closed loop: {run_s:.3f} s (first call), {res.bytes_written} "
            f"bytes, mean Y-PSNR {res.mean_psnr_y:.2f} dB, slice QPs "
            f"{sorted(set(qps))}; wavefront kernel {got['wavefront_encode_planes']}"
            f" launches, filter kernels {filter_want(cfg, 2 * batches)}, no "
            f"other kernel; each frame == its single-frame "
            f"encode (levels, modes, SAO parameters); decode_sequence on the "
            f"card == recon ({dec_s:.2f} s) [{gpu}]")
    return total


def run_cli(argv: list) -> str:
    """The port's CLI on argument lists, in one process; its stdout."""
    proc = subprocess.run(
        [sys.executable, "-c", "import json, sys; from nanohevc_tpu_torch"
         ".cli import main; [main(a) for a in json.loads(sys.argv[1])]",
         json.dumps(argv)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise SystemExit(f"CLI failed (rc {proc.returncode}):\n{proc.stderr}")
    return proc.stdout


def phase_filters_cli(dev, tmp: str, frame: Frame, frames: list,
                      ctb: tuple, gpu: str) -> None:
    """8d, through the CLI in one process: `encode --pipeline closed-loop
    --deblock --sao-ctb` then `decode` on the card == the API's bytes and
    recon; `--hevc-export` (4:2:0 with the default DC chroma mode, and
    --hevc-mono) of a 256x256 crop and `encode-seq --hevc-export` of a
    4-frame 270x480 file: the card's streams == the CPU's."""
    t0 = time.perf_counter()
    full = write_yuv(os.path.join(tmp, "filters_frame.yuv"), [frame])
    out, rec, dec = (os.path.join(tmp, f"filters_{k}") for k in
                     ("cli.bin", "rec.yuv", "dec.yuv"))
    argv = [["encode", full, "--width", str(W), "--height", str(H),
             "--pipeline", "closed-loop", "--bitstream", out, "-o", rec,
             "--deblock", "--sao-ctb"], ["decode", out, "-o", dec]]
    small = crop(frame, 256, 256)
    one = write_yuv(os.path.join(tmp, "export.yuv"), [small])
    few = write_yuv(os.path.join(tmp, "export_seq.yuv"),
                    [crop(f, 270, 480) for f in frames[:4]])
    exports = {}
    for device in ("cuda", "cpu"):
        exports[device] = [os.path.join(tmp, f"{device}_{k}.hevc")
                           for k in ("420", "mono", "seq")]
        outs = exports[device]
        argv += [
            ["--device", device, "encode", one, "--width", "256", "--height",
             "256", "--pipeline", "closed-loop", "--hevc-export", outs[0]],
            ["--device", device, "encode", one, "--width", "256", "--height",
             "256", "--pipeline", "closed-loop", "--hevc-export", outs[1],
             "--hevc-mono"],
            ["--device", device, "encode-seq", few, "--width", "480",
             "--height", "270", "--frames", "4", "--batch", "2",
             "--closed-loop", "--no-resume", "--bitstream",
             os.path.join(tmp, f"{device}_seq.bin"), "--hevc-export", outs[2]],
        ]
    run_cli(argv)
    with open(out, "rb") as f:
        cli_bits = f.read()
    with open(rec, "rb") as f:
        cli_rec = f.read()
    with open(dec, "rb") as f:
        cli_dec = f.read()
    if cli_bits != ctb[0]:
        raise SystemExit("8d: CLI bitstream differs from the library encode")
    if not cli_rec == cli_dec == ctb[1].to_yuv420p():
        raise SystemExit("8d: CLI recon or decoded YUV differs from the recon")
    streams = {}
    for device, paths in exports.items():
        streams[device] = []
        for path in paths:
            with open(path, "rb") as f:
                streams[device].append(f.read())
    if streams["cuda"] != streams["cpu"]:
        raise SystemExit("8d: --hevc-export streams on the card != the CPU's")
    log(f"[8d] CLI encode --pipeline closed-loop --deblock --sao-ctb on the "
        f"GPU, then decode: bitstream identical ({len(cli_bits)} bytes), "
        f"decoded YUV == recon YUV; --hevc-export on the card == on the "
        f"CPU: 256x256 4:2:0 (DC chroma) {len(streams['cuda'][0])} bytes, "
        f"--hevc-mono {len(streams['cuda'][1])} bytes, encode-seq 4 frames "
        f"270x480 {len(streams['cuda'][2])} bytes (one process, "
        f"{time.perf_counter() - t0:.1f} s) [{gpu}]")


def phase_filters(dev, tmp: str, src: str, frame: Frame, frames: list,
                  base_bits: dict, gpu: str) -> dict:
    """8: the loop filters (8a-8c) and the CLI with the filters and the
    standard export (8d).  Returns the wavefront kernel's launches by
    body on the main paths 8b and 8c."""
    marks = [time.perf_counter()]
    phase_filters_crops(dev, frame, gpu)
    marks.append(time.perf_counter())
    launches, streams = phase_filters_frame(dev, frame, base_bits, gpu)
    marks.append(time.perf_counter())
    launches["dc_planar"] += phase_filters_sequence(dev, tmp, src, frames,
                                                    gpu)
    marks.append(time.perf_counter())
    phase_filters_cli(dev, tmp, frame, frames,
                      streams["deblock+sao_ctb", "default"], gpu)
    marks.append(time.perf_counter())
    split = ", ".join(f"8{k} {b - a:.1f} s" for k, a, b
                      in zip("abcd", marks, marks[1:]))
    log(f"[8] loop filters and export: {marks[-1] - marks[0]:.1f} s "
        f"({split}) [{gpu}]")
    return launches


# --- multi-device encoding (9) ---------------------------------------------

MESH_FRAMES = 4          # the 1080p luma batch of 9a-9b
MESH_SEQ_FRAMES, MESH_SEQ_BATCH = 8, 4


def build_mesh(dev):
    """Every visible card when there are 2 or more (space 2 where the
    count is even), else a logical (2, 2) mesh on `dev`."""
    count = torch.cuda.device_count()
    if count >= 2:
        space = 2 if count % 2 == 0 else 1
        return make_mesh(space=space), f"{count} cards"
    return make_mesh([dev] * 4, space=2), f"a logical mesh on {dev}"


def same_outputs(a: dict, b: dict, keys) -> bool:
    """Equal tensors (or tuples of tensors, the SAO maps), compared on
    the host."""
    def eq(x, y):
        if isinstance(x, tuple):
            return len(x) == len(y) and all(eq(p, q) for p, q in zip(x, y))
        return torch.equal(x.cpu(), y.cpu())
    return all(eq(a[k], b[k]) for k in keys)


def turns_ms(fns: dict, repeats: int = 5) -> dict:
    """Median host-clock ms of each call (ended by a synchronise), the
    calls taken in turns."""
    took = {k: [] for k in fns}
    for r in range(repeats):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            took[k].append(1e3 * (time.perf_counter() - t0))
    return {k: sorted(v)[repeats // 2] for k, v in took.items()}


def mesh_batch(mesh, planes, config: EncoderConfig, closed: bool,
               want: dict, tag: str, label: str, gpu: str) -> tuple:
    """One batch encoder under the mesh, with the launch counts reset
    just before it and read just after (they must equal `want`), and
    the mesh-less encoder on the same planes: equal bit for bit (recon,
    levels, modes, nnz, SAO maps, psnr; mean_psnr within 1e-6, a mean
    of shard means under the closed loop).  Returns the launches, the
    mesh's outputs and the turns' times."""
    make = make_closed_loop_encoder if closed else make_batch_encoder
    on_mesh, alone = make(config, mesh), make(config)
    copies = slab_encode_plane.copies
    reset_launches()
    got = on_mesh(planes, config.qp)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != want:
        raise SystemExit(f"[{tag}] {label} under the mesh launched {launches}, "
                         f"expected {want}")
    check_filters(f"[{tag}] {label} under the mesh", filter_want(
        config, want["wavefront_encode_planes"] if closed else 0))
    ref = alone(planes, config.qp)
    keys = [k for k in ref if k != "mean_psnr"]
    if sorted(got) != sorted(ref) or not same_outputs(got, ref, keys):
        raise SystemExit(f"[{tag}] {label}: the mesh's outputs differ from "
                         "the mesh-less encoder's")
    if abs(float(got["mean_psnr"]) - float(ref["mean_psnr"])) > \
            1e-6 * abs(float(ref["mean_psnr"])):
        raise SystemExit(f"[{tag}] {label}: mean_psnr differs")
    ms = turns_ms({"mesh": lambda: on_mesh(planes, config.qp),
                   "alone": lambda: alone(planes, config.qp)})
    log(f"[{tag}] {label}, {planes.shape[0]} 1080p luma planes: mesh == "
        f"mesh-less ({', '.join(keys)}); launches {launches} "
        f"(copies {slab_encode_plane.copies - copies}); mesh call "
        f"{ms['mesh']:.2f} ms, mesh-less {ms['alone']:.2f} ms (host clock, "
        f"median of 5 in turns) [{gpu}]")
    return launches, got


def phase_mesh_crop(dev, mesh, frames: list, gpu: str) -> None:
    """9c: 4-frame crops on the card mesh == the same-shape mesh of
    "cpu" entries: 138x250 (no sharded kernel covers it: the plain
    route and the closed loop) and 136x248 (the sharded kernels with a
    bottom pad)."""
    cpu_mesh = make_mesh(["cpu"] * mesh.devices.size,
                         space=mesh.shape["space"])
    cases = 0
    for h, w in ((138, 250), (136, 248)):
        planes = np.stack([f.y.data[:h, :w] for f in frames[:MESH_FRAMES]]
                          ).astype(np.int32)
        for label, cfg, make in (
                ("default", EncoderConfig(), make_batch_encoder),
                ("mode search", MODE_SEARCH, make_batch_encoder),
                ("closed loop", EncoderConfig(), make_closed_loop_encoder)):
            card = make(cfg, mesh)(torch.from_numpy(planes).to(dev), cfg.qp)
            cpu = make(cfg, cpu_mesh)(torch.from_numpy(planes), cfg.qp)
            keys = [k for k in cpu if k not in ("psnr", "mean_psnr")]
            if not same_outputs(card, cpu, keys) or not torch.allclose(
                    card["psnr"].cpu(), cpu["psnr"], rtol=1e-6, atol=0):
                raise SystemExit(f"[9c] {label} on a {h}x{w} crop: the card "
                                 "mesh differs from the CPU mesh")
            cases += 1
    log(f"[9c] {cases} encodes of 4-frame 138x250 and 136x248 crops (open "
        f"default and mode search, closed loop): card mesh == CPU mesh "
        f"(psnr within 1e-6) [{gpu}]")


def phase_mesh_sequence(dev, mesh, tmp: str, src: str, closed_recon: bytes,
                        gpu: str) -> dict:
    """9d: encode_sequence of 8 1080p frames at batch 4 under the mesh,
    open and closed loop (default config): the kernels launch on the
    mesh's shards, the bytes equal the mesh-less run's, and the
    closed-loop stream decodes on the card to 4g's recon of the same
    frames.  Returns the launches by kernel."""
    fa, sa = mesh.devices.shape
    batches = MESH_SEQ_FRAMES // MESH_SEQ_BATCH
    launches = {}
    for closed, kern, per_batch in (
            (False, "slab_encode_plane", 3 * MESH_SEQ_BATCH * sa),
            (True, "wavefront_encode_planes", 2 * fa)):
        bits = {}
        for how, kw in (("mesh", {"mesh": mesh}), ("alone", {})):
            bits[how] = os.path.join(tmp, f"mesh_{int(closed)}_{how}.bin")
            reset_launches()
            t0 = time.perf_counter()
            seq.encode_sequence(src, W, H, MESH_SEQ_FRAMES, EncoderConfig(),
                                bits[how], batch=MESH_SEQ_BATCH,
                                closed_loop=closed, resume=False, device=dev,
                                **kw)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            if how == "mesh":
                n = read_launches()
                want = {k: batches * per_batch if k == kern else 0
                        for k in KERNELS}
                if n != want:
                    raise SystemExit(f"[9d] sequence under the mesh launched "
                                     f"{n}, expected {want}")
                launches[kern] = n[kern]
                mesh_s = took
        with open(bits["mesh"], "rb") as f, open(bits["alone"], "rb") as g:
            data = f.read()
            if data != g.read():
                raise SystemExit(f"[9d] {'closed' if closed else 'open'}-loop "
                                 "sequence under the mesh: bytes differ from "
                                 "the mesh-less run")
        note = ""
        if closed:
            dec = os.path.join(tmp, "mesh_dec.yuv")
            n = counted_decode(
                "[9d] decode_sequence", sequence_decodes(MESH_SEQ_FRAMES),
                lambda: seq.decode_sequence(bits["mesh"], dec, device=dev))
            size = MESH_SEQ_FRAMES * H * W * 3 // 2
            with open(dec, "rb") as f:
                if n != MESH_SEQ_FRAMES or f.read() != closed_recon[:size]:
                    raise SystemExit("[9d] the mesh's closed-loop stream does "
                                     "not decode to the recon")
            note = "; decode_sequence on the card == recon"
        log(f"[9d] encode_sequence {'closed' if closed else 'open'} loop, "
            f"{MESH_SEQ_FRAMES} 1080p frames at batch {MESH_SEQ_BATCH} under "
            f"the mesh: {mesh_s:.3f} s (first call), {len(data)} bytes == "
            f"mesh-less run, launches {launches[kern]}{note} [{gpu}]")
    return launches


def phase_mesh(dev, tmp: str, src: str, frames: list, closed_recon: bytes,
               gpu: str) -> tuple:
    """9: the multi-device encoders (`parallel`) on the card.  Returns
    the launches of the mesh's main paths: by kernel, and the wavefront
    kernel's by body."""
    t0 = time.perf_counter()
    mesh, kind = build_mesh(dev)
    fa, sa = mesh.devices.shape
    log(f"[9] mesh {mesh.shape} over {kind}")
    planes = torch.from_numpy(np.stack(
        [f.y.data for f in frames[:MESH_FRAMES]]).astype(np.int32)).to(dev)
    launches = {"slab_encode_plane": 0, "mode_search_encode_plane": 0}
    wf = {"dc_planar": 0, "search": 0}
    # 1080 rows are no whole number of 16-row block-rows: no row shards,
    # K1 on each plane of the frame shards
    for label, cfg, kern, per_plane in (
            ("default", EncoderConfig(), "slab_encode_plane", sa),
            ("mode search", MODE_SEARCH, "mode_search_encode_plane", sa),
            ("block 16, frame shards", EncoderConfig(block_size=16),
             "slab_encode_plane", 1)):
        want = {k: MESH_FRAMES * per_plane if k == kern else 0
                for k in KERNELS}
        n, out = mesh_batch(mesh, planes, cfg, False, want, "9a",
                            f"open loop, {label}", gpu)
        launches[kern] += n[kern]
        if label == "default":
            raster = ops.scan_unpack(out["levels"][0].cpu(), cfg.scan,
                                     modes=out["modes"][0].cpu())
            bad = sample_parity_check(frames[0].y.data.astype(np.int32),
                                      raster.numpy(), out["recon"][0].cpu()
                                      .numpy(), cfg.block_size, cfg.qp)
            if bad:
                raise SystemExit(f"[9a] sample_parity_check: {bad} blocks "
                                 "differ from the oracle")
            log("[9a] sample_parity_check on the mesh's first frame: 0 of 64 "
                "sampled blocks differ from the oracle")
    want = {k: fa if k == "wavefront_encode_planes" else 0 for k in KERNELS}
    for label, cfg, body in (
            ("default", EncoderConfig(), "dc_planar"),
            ("mode search", MODE_SEARCH, "search"),
            ("deblock+sao_ctb", EncoderConfig(deblock=True, sao_ctb=True),
             "dc_planar")):
        n, _ = mesh_batch(mesh, planes, cfg, True, want, "9b",
                          f"closed loop, {label}", gpu)
        wf[body] += n["wavefront_encode_planes"]
    phase_mesh_crop(dev, mesh, frames, gpu)
    for kern, n in phase_mesh_sequence(dev, mesh, tmp, src, closed_recon,
                                       gpu).items():
        if kern == "wavefront_encode_planes":
            wf["dc_planar"] += n
        else:
            launches[kern] += n
    log(f"[9] multi-device phase: {time.perf_counter() - t0:.1f} s, launches "
        f"{launches}, wavefront by body {wf} [{gpu}]")
    return launches, wf


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(gpu)        # as nvidia-smi prints it: name, power limit
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    for stem, info in build.build_libraries().items():
        log(f"[2] built {os.path.relpath(info.path, ROOT)} in "
            f"{info.seconds:.2f} s{' (cached)' if info.cached else ''}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2]   {line.strip()}")

    worst = {
        "slab_encode_plane": max(
            phase_kernel_vs_plain(dev, "slab_encode_plane", "3"),
            phase_slab_edges(dev)),
        "mode_search_encode_plane": phase_kernel_vs_plain(
            dev, "mode_search_encode_plane", "3b", wide_bits=True),
        "wavefront_encode_planes": phase_wavefront_vs_plain(dev),
        **{f"scan {row}": err
           for row, err in phase_wavefront_scan_vs_plain(dev).items()},
        **{f"rd {mode_set}": err
           for mode_set, err in phase_wavefront_rd_vs_plain(dev).items()},
        "fused_encode_blocks": phase_fused_vs_plain(dev),
    }
    phase_rd_prices(dev, gpu)
    frame = make_frame(np.random.default_rng(SEED))
    config = EncoderConfig()
    launches = {}
    launches["slab_encode_plane"], bits = phase_main_path(
        dev, frame, config, "slab_encode_plane", "4")
    launches["mode_search_encode_plane"], ms_bits = phase_main_path(
        dev, frame, MODE_SEARCH, "mode_search_encode_plane", "4b")
    # The wavefront kernel's main paths are both closed-loop configs,
    # one a body: its launches are counted per body.
    wf_launches = {}
    wf_launches["dc_planar"], cl_bits, cl_recon = phase_closed_loop(
        dev, frame, config, "4c")
    wf_launches["search"], ms_cl_bits, ms_cl_recon = phase_closed_loop(
        dev, frame, MODE_SEARCH, "4d")
    worst["decode_blocks"] = phase_decode_vs_plain(dev, ms_cl_bits, gpu)
    worst.update(phase_filters_vs_plain(dev, frame, gpu))
    launches["fused_encode_blocks"], planes8 = phase_fused_main(dev)

    # The sequence runner drives K1, K2 and the wavefront kernel: each
    # run's launches add to those of the kernel's single-frame paths.
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    frames = sequence_frames(SEQ_FRAMES, H, W, SEED + 3)
    src = write_yuv(os.path.join(tmp, "seq.yuv"), frames)
    seq_bits = {}
    for tag, label, cfg, kern in (
            ("4f", "default", config, "slab_encode_plane"),
            ("4f-search", "mode search", MODE_SEARCH,
             "mode_search_encode_plane")):
        n, seq_bits[label] = phase_sequence_open(dev, tmp, src, frames, label,
                                                 cfg, tag)
        launches[kern] += n
    for tag, label, cfg, body in (
            ("4g", "closed loop default", config, "dc_planar"),
            ("4g-search", "closed loop mode search", MODE_SEARCH, "search")):
        n, seq_bits[label], recon = phase_sequence_closed(
            dev, tmp, src, frames, label, cfg, tag)
        wf_launches[body] += n
        if label == "closed loop default":
            closed_recon = recon
    bpp_at_22 = 8 * os.path.getsize(seq_bits["default"]) / (SEQ_FRAMES * H * W)
    rc_bits = phase_rate_and_resume(dev, tmp, src, seq_bits["default"],
                                    bpp_at_22, gpu)

    phase_scan_configs(dev, frame, gpu)

    phase_cli(frame, bits, [], "5")
    phase_cli(frame, ms_bits, ["--mode-search"], "5b")
    phase_cli_closed_loop(frame, cl_bits, cl_recon, [], "5c")
    phase_cli_closed_loop(frame, ms_cl_bits, ms_cl_recon, ["--mode-search"],
                          "5c")
    phase_cli_sequence(dev, tmp, src, frames[0], {
        "open": seq_bits["default"], "closed": seq_bits["closed loop default"],
        "rc": rc_bits[False][0], "target_bpp": rc_bits[False][1],
        "recon": closed_recon,
        "target_bytes": len(assemble_frame_bitstream(
            W, H, config, encode_frame_full(frames[0], config,
                                            device=dev)[1])) // 2,
    })
    times = {
        "slab_encode_plane": kernel_times(dev, "slab_encode_plane", "6", gpu),
        "mode_search_encode_plane": kernel_times(
            dev, "mode_search_encode_plane", "6b", gpu),
    }
    wf = wavefront_times(dev, gpu)
    scan_ms = scan_times(dev, gpu)
    rd_ms = rd_times(dev, gpu)
    frame_times(dev, frame, config, "default config:", gpu)
    frame_times(dev, frame, MODE_SEARCH, "mode search:", gpu)
    closed_loop_times(dev, frame, config, "default config:", gpu)
    closed_loop_times(dev, frame, MODE_SEARCH, "mode search:", gpu)
    dec_times, dec_bound = decode_times(dev, frame, gpu)
    flt_ms = filter_times(dev, frame, gpu)
    decode_frame_split(dev, cl_bits, "default", gpu)
    decode_frame_split(dev, ms_cl_bits, "mode search", gpu)
    times["fused_encode_blocks"] = fused_times(dev, planes8, gpu)
    sequence_times(dev, tmp, src, frames, seq_bits["closed loop default"], gpu)
    phase_rd(dev, tmp, src, frame, frames, gpu)
    for body, n in phase_filters(dev, tmp, src, frame, frames, {
            "default": (cl_bits, cl_recon),
            "mode search": (ms_cl_bits, ms_cl_recon)}, gpu).items():
        wf_launches[body] += n
    mesh_launches, mesh_wf = phase_mesh(dev, tmp, src, frames, closed_recon,
                                        gpu)
    for name, n in mesh_launches.items():
        launches[name] += n
    for body, n in mesh_wf.items():
        wf_launches[body] += n
    tmp_dir.cleanup()

    # ms and bounds at the main path's shape, a 1080p luma plane at N = 8;
    # the wavefront kernel has an entry per body, each with its launches
    # and the TPU kernels that body replaces.
    n8 = config.block_size
    rows = [(name, times[name][n8], launches[name], worst[name],
             kernel_bound(name == "mode_search_encode_plane", n8, H * W),
             KERNELS[name][3])
            for name in ("slab_encode_plane", "mode_search_encode_plane")]
    for body, label, replaces in (
            ("dc_planar", "wavefront_encode_planes",
             "nanohevc_tpu/kernels/wavefront_slab.py:151"),
            ("search", "wavefront_encode_planes (search body)",
             "nanohevc_tpu/kernels/wavefront_mode_grouped.py:199, "
             "nanohevc_tpu/kernels/wavefront_mode_slab.py:182")):
        rows.append((label, wf[body, n8], wf_launches[body],
                     worst["wavefront_encode_planes"],
                     kernel_bound(body == "search", n8, H * W), replaces))
    # what the kernel took over from JAX's closed-loop XLA scan, a row
    # each: main-path launches of 4i and 7b-7d
    for row, (label, _) in SCAN_ROWS.items():
        if not SCAN_LAUNCHES[row]:
            raise SystemExit(f"{label}: no launch on the main paths")
        rows.append((label, scan_ms[row], SCAN_LAUNCHES[row],
                     worst[f"scan {row}"], scan_bound(row, n8, H * W),
                     XLA_SCAN))
    # the RD closed loop's kernel, a row a mode set: main-path launches
    # of 7b-7d and 8a
    rd_diagonals = -(-H // n8) - (-W // n8) - 1
    for mode_set, label in RD_SETS.items():
        if not RD_LAUNCHES[mode_set]:
            raise SystemExit(f"{label}: no launch on the main paths")
        rows.append((label, rd_ms[mode_set], RD_LAUNCHES[mode_set],
                     worst[f"rd {mode_set}"],
                     rd_bound(mode_set, n8, H * W, rd_diagonals),
                     KERNELS["wavefront_rd_encode_planes"][3]))
    rows.append(("fused_encode_blocks", times["fused_encode_blocks"][n8],
                 launches["fused_encode_blocks"], worst["fused_encode_blocks"],
                 fused_bound(n8, H * W), KERNELS["fused_encode_blocks"][3]))
    # the decode kernel on the search stream's luma plane at N = 8
    rows.append(("decode_blocks", dec_times[n8], DECODE_LAUNCHES["main"],
                 worst["decode_blocks"], dec_bound,
                 KERNELS["decode_blocks"][3]))
    # the loop filters' kernels on the 1080p luma plane (CTB SAO at tiles
    # of 64): main-path launches of 8a-8c and 9b
    luma_tiles = -(-H // 64) * -(-W // 64)
    for name, (_, _, replaces) in FILTER_KERNELS.items():
        if not FILTER_LAUNCHES[name]:
            raise SystemExit(f"{name}: no launch on the main paths")
        rows.append((name, flt_ms[name], FILTER_LAUNCHES[name], worst[name],
                     filter_bound(name, 1, H * W, luma_tiles), replaces))
    entries = []
    for name, (k_ms, p_ms), count, err, (bound_ms, bound_by), replaces in rows:
        key = name.split(" ")[0]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": (FILTER_KERNELS[key][1] if key in FILTER_KERNELS
                       else KERNELS[key][2]),
            "replaces": replaces,
            "launches": count,
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,    # no one PyTorch call codes a block
        })
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
