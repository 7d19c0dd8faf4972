"""Command-line interface: `python -m nanohevc_tpu_torch [--device cuda|cpu]
demo|encode|encode-seq|decode`.

Output text and files equal those of `python -m nanohevc_tpu` for the
same arguments: the open-loop encode (DC/planar, the 35-mode search,
reference smoothing), the closed loop (`encode --pipeline
closed-loop`), the RD tools (`--rdo`, `--rdoq`, `--decision rd`), the
in-loop filters (`--deblock`, `--sao`, `--sao-ctb`, `--sao-tile`;
closed loop only), fixed chroma modes (`--chroma-mode`), the standard
Annex B export (`--hevc-export`, `--hevc-mono`), the rate search
(`encode --target-bytes`), the sequence runner (`encode-seq`, with
resume and `--target-bpp` rate control) and `decode` of single-frame
and sequence streams.  `--platform` (a JAX backend flag) exits with
rc 2; `--device` takes its place.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def demo_predictions(height: int, width: int, block_size: int, device) -> None:
    """DC vs planar demo on the synthetic test frame."""
    import torch

    from nanohevc_tpu_torch.ref.metrics import psnr
    from nanohevc_tpu_torch import ops
    from nanohevc_tpu_torch.models.all_intra import create_test_frame

    print("nanohevc-tpu intra prediction demo")
    print(f"Frame: {width}x{height}, Block size: {block_size}x{block_size}")
    print("=" * 60)

    frame = create_test_frame(height, width)
    plane = torch.from_numpy(frame.y.data.astype(np.int32)).to(device)
    n = block_size
    blocks = ops.tile_plane(plane, n)
    refs = ops.extract_refs(plane, n)
    dc_pred = ops.dc_predict(refs, n)
    pl_pred = ops.planar_predict(refs, n)
    dc_energy = ops.residual_energy_blocks(blocks - dc_pred).cpu().numpy()
    pl_energy = ops.residual_energy_blocks(blocks - pl_pred).cpu().numpy()

    nbx = width // n
    nb = dc_energy.shape[0]
    print(f"\n{'Block':<12} {'DC Energy':>12} {'Planar Energy':>14} {'Winner':>10}")
    print("-" * 60)
    for b in range(min(nb, 16)):
        x, y = (b % nbx) * n, (b // nbx) * n
        winner = "DC" if dc_energy[b] <= pl_energy[b] else "Planar"
        print(f"({x:3},{y:3})    {dc_energy[b]:>12} {pl_energy[b]:>14} {winner:>10}")
    if nb > 16:
        print(f"... ({nb - 16} more blocks)")
    print("-" * 60)

    dc_wins = int((dc_energy <= pl_energy).sum())
    print("\nSummary:")
    print(f"  Total blocks: {nb}")
    print(f"  DC wins:      {dc_wins} ({100 * dc_wins / nb:.1f}%)")
    print(f"  Planar wins:  {nb - dc_wins} ({100 * (nb - dc_wins) / nb:.1f}%)")
    print(f"\n  DC total residual energy:     {int(dc_energy.sum()):,}")
    print(f"  Planar total residual energy: {int(pl_energy.sum()):,}")

    wins = torch.from_numpy(dc_energy <= pl_energy).to(device)
    best = torch.where(wins[:, None, None], dc_pred, pl_pred).clamp(0, 255)
    recon = ops.untile_plane(best, height, width).cpu().numpy()
    value = psnr(frame.y.data.astype(np.uint8), recon.astype(np.uint8))
    print(f"\n  Reconstruction PSNR (best mode): {value:.2f} dB")


def cmd_demo(args: argparse.Namespace) -> None:
    demo_predictions(args.height, args.width, args.block_size, args.device)


def cmd_encode(args: argparse.Namespace) -> None:
    from nanohevc_tpu_torch.config import EncoderConfig
    from nanohevc_tpu_torch.frame import Frame
    from nanohevc_tpu_torch.ref.metrics import psnr
    from nanohevc_tpu_torch.models.all_intra import (
        encode_frame_full,
        encode_frame_intra,
    )

    with open(args.input, "rb") as f:
        data = f.read()
    expected = args.width * args.height * 3 // 2
    if len(data) < expected:
        print(f"Error: file too small. Expected {expected} bytes, got {len(data)}")
        sys.exit(1)

    frame = Frame.from_yuv420p(data[:expected], args.height, args.width)
    print(f"Loaded: {args.input} ({args.width}x{args.height})")

    if args.target_bytes and args.pipeline == "predict":
        print(
            "Error: --target-bytes needs a coded bitstream to measure; "
            "use --pipeline full or closed-loop",
            file=sys.stderr,
        )
        sys.exit(1)

    if args.rdoq and args.pipeline == "predict":
        print(
            "Error: --rdoq adjusts quantized levels; use --pipeline "
            "full or closed-loop",
            file=sys.stderr,
        )
        sys.exit(1)

    if (args.deblock or args.sao or args.sao_ctb) and \
            args.pipeline != "closed-loop":
        which = ("--deblock" if args.deblock
                 else "--sao" if args.sao else "--sao-ctb")
        print(
            f"Error: {which} is an in-loop filter on the decodable "
            "reconstruction; use --pipeline closed-loop",
            file=sys.stderr,
        )
        sys.exit(1)

    if args.hevc_export:
        _check_export(args, "--pipeline closed-loop",
                      args.pipeline == "closed-loop")

    if args.pipeline == "closed-loop":
        config = EncoderConfig(
            block_size=args.block_size,
            qp=args.qp,
            mode_set="all" if args.mode_search else "dc_planar",
            decision=args.decision or ("satd" if args.mode_search else "energy"),
            chroma_mode_set=args.chroma_mode,
            scan=args.scan,
            entropy_coder=args.entropy,
            rdoq=args.rdoq,
            dequant_rescale=args.dequant_rescale,
            intra_smoothing=args.intra_smoothing,
            deblock=args.deblock,
            sao=args.sao,
            sao_ctb=args.sao_ctb,
            sao_tile=args.sao_tile,
        )
        if args.target_bytes:
            config = _rate_search(frame, config, args)
        encode_closed_loop(frame, config, args)
        return

    if args.pipeline == "predict":
        recon, stats = encode_frame_intra(
            frame, args.block_size, args.output, device=args.device
        )
        if args.output:
            print(f"Wrote: {args.output}")
        y_psnr = psnr(
            frame.y.data.astype(np.uint8), recon.y.data.astype(np.uint8)
        )
        print("\nResults:")
        print(
            f"  Blocks: {stats['blocks']} (DC: {stats['dc']}, "
            f"Planar: {stats['planar']})"
        )
        print(f"  Y-PSNR: {y_psnr:.2f} dB")
        return

    config = EncoderConfig(
        block_size=args.block_size,
        qp=args.qp,
        mode_set="all" if args.mode_search else "dc_planar",
        decision=args.decision or ("satd" if args.mode_search else "energy"),
        scan=args.scan,
        entropy_coder=args.entropy,
        rdo_cbf=args.rdo,
        rdoq=args.rdoq,
        dequant_rescale=args.dequant_rescale,
        intra_smoothing=args.intra_smoothing,
    )
    if args.target_bytes:
        config = _rate_search(frame, config, args)
    recon, info = encode_frame_full(frame, config, device=args.device)
    if args.output:
        with open(args.output, "wb") as f:
            f.write(recon.to_yuv420p())
        print(f"Wrote: {args.output}")
    nnz = sum(p["nnz"] for p in info["planes"].values())
    print("\nResults:")
    print(f"  Blocks: {info['blocks']}  QP: {args.qp}")
    print(f"  Non-zero coefficients: {nnz}")
    print(f"  Y-PSNR: {info['psnr_y']:.2f} dB")
    if args.bitstream:
        bs = assemble_frame_bitstream(args.width, args.height, config, info)
        with open(args.bitstream, "wb") as f:
            f.write(bs)
        raw = args.width * args.height * 3 // 2
        print(
            f"  Bitstream: {args.bitstream} ({len(bs)} bytes, "
            f"{8 * len(bs) / (args.width * args.height):.3f} bpp, "
            f"{raw / len(bs):.1f}x vs raw YUV)"
        )


def _rate_search(frame, config, args: argparse.Namespace):
    """Pick the QP that fits the byte budget on the chosen pipeline."""
    from dataclasses import replace

    from nanohevc_tpu_torch.models.rate_control import find_frame_qp

    qp, size = find_frame_qp(
        frame, config, args.target_bytes,
        closed_loop=args.pipeline == "closed-loop", device=args.device,
    )
    print(f"Rate search: QP {qp} fits {args.target_bytes} bytes "
          f"({size} coded)")
    args.qp = qp
    return replace(config, qp=qp)


def _check_export(args: argparse.Namespace, loop_flag: str,
                  closed_loop: bool) -> None:
    """--hevc-export's checks: no filter (the exported SPS/PPS declare
    them off), the closed loop, and a fixed chroma mode (DC unless
    --chroma-mode says otherwise) for a 4:2:0 stream."""
    bad = [f for f, on in (
        ("--deblock", args.deblock), ("--sao", args.sao),
        ("--sao-ctb", args.sao_ctb),
    ) if on]
    if bad:
        print(
            f"Error: {' '.join(bad)} cannot be represented in the "
            "standard-syntax export (its PPS disables deblocking and "
            "its SPS has SAO off); drop the flag or the export",
            file=sys.stderr,
        )
        sys.exit(1)
    if not closed_loop:
        print(f"Error: --hevc-export requires {loop_flag}", file=sys.stderr)
        sys.exit(1)
    if args.chroma_mode is None and not args.hevc_mono:
        # the spec signals ONE chroma mode per CU for both Cb and Cr
        args.chroma_mode = "dc"
        print("HEVC export: chroma planes use fixed DC mode "
              "(--chroma-mode to override)")


def _plane_raster(parsed: dict, name: str, n: int, scan: str):
    """Container-parsed plane -> (raster levels (nb, n, n), modes)."""
    from nanohevc_tpu_torch.runtime.bitstream import _np_unpack, _slice_scan_sel

    p = parsed[name]
    sel = _slice_scan_sel(scan, p["modes"], p["levels"].shape[0], n)
    return _np_unpack(p["levels"], sel, n), np.asarray(p["modes"])


_MODES_DIFFER = ("U and V planes coded different intra modes; the spec "
                 "signals ONE chroma mode per CU \u2014 encode with "
                 "--chroma-mode dc|planar")


def _export_standard_stream(bitstream: bytes, config, height: int,
                            width: int, mono: bool = False) -> bytes:
    """Standard-syntax Annex B stream of an already coded container
    bitstream (no second encode)."""
    from nanohevc_tpu_torch.runtime.bitstream import parse_bitstream
    from nanohevc_tpu_torch.runtime.hevc_stream import (
        export_hevc_stream,
        export_hevc_stream_420,
    )

    parsed = parse_bitstream(bitstream)
    ly, my = _plane_raster(parsed, "Y", config.block_size, config.scan)
    if mono:
        return export_hevc_stream(
            ly, my, height, width, config.block_size, config.qp,
            config.bit_depth,
        )
    nc = config.chroma_block_size()
    lu, mu = _plane_raster(parsed, "U", nc, config.scan)
    lvv, mv = _plane_raster(parsed, "V", nc, config.scan)
    if not np.array_equal(mu, mv):
        raise ValueError(_MODES_DIFFER)
    return export_hevc_stream_420(
        ly, my, lu, lvv, mu, height, width, config.block_size,
        config.qp, config.bit_depth,
    )


def encode_closed_loop(frame, config, args: argparse.Namespace) -> None:
    """`encode --pipeline closed-loop`: the decodable wavefront encode,
    and its standard-syntax export with --hevc-export."""
    from nanohevc_tpu_torch.models.wavefront import encode_frame_closed_loop
    from nanohevc_tpu_torch.ref.metrics import psnr

    recon, bitstream = encode_frame_closed_loop(frame, config,
                                                device=args.device)
    if args.output:
        with open(args.output, "wb") as f:
            f.write(recon.to_yuv420p())
        print(f"Wrote: {args.output}")
    y_psnr = psnr(frame.y.data.astype(np.uint8), recon.y.data.astype(np.uint8))
    print("\nResults:")
    print(f"  QP: {args.qp}  Y-PSNR: {y_psnr:.2f} dB (reconstruction-fed)")
    if args.bitstream:
        with open(args.bitstream, "wb") as f:
            f.write(bitstream)
        raw = args.width * args.height * 3 // 2
        print(
            f"  Bitstream: {args.bitstream} ({len(bitstream)} bytes, "
            f"{raw / len(bitstream):.1f}x vs raw, decodable)"
        )
    if args.hevc_export:
        stream = _export_standard_stream(
            bitstream, config, args.height, args.width, mono=args.hevc_mono)
        with open(args.hevc_export, "wb") as f:
            f.write(stream)
        kind = "luma, monochrome" if args.hevc_mono else "4:2:0 YUV"
        print(f"  HEVC export ({kind} Annex B): "
              f"{args.hevc_export} ({len(stream)} bytes)")


def cmd_encode_seq(args: argparse.Namespace) -> None:
    from nanohevc_tpu_torch.config import EncoderConfig
    from nanohevc_tpu_torch.models.sequence import encode_sequence

    if args.hevc_export:
        _check_export(args, "--closed-loop", args.closed_loop)
    config = EncoderConfig(
        block_size=args.block_size,
        qp=args.qp,
        mode_set="all" if args.mode_search else "dc_planar",
        decision=args.decision or ("satd" if args.mode_search else "energy"),
        chroma_mode_set=args.chroma_mode,
        scan=args.scan,
        entropy_coder=args.entropy,
        rdo_cbf=args.rdo,
        rdoq=args.rdoq,
        dequant_rescale=args.dequant_rescale,
        intra_smoothing=args.intra_smoothing,
        deblock=args.deblock,
        sao=args.sao,
        sao_ctb=args.sao_ctb,
        sao_tile=args.sao_tile,
    )
    res = encode_sequence(
        args.input,
        args.width,
        args.height,
        args.frames,
        config,
        args.bitstream,
        batch=args.batch,
        resume=not args.no_resume,
        report_every=args.report_every,
        closed_loop=args.closed_loop,
        target_bpp=args.target_bpp,
        entropy_tiles=args.entropy_tiles,
        device=args.device,
    )
    print("\nSequence results:")
    if res.resumed_from:
        print(f"  Resumed from frame {res.resumed_from}")
    print(f"  Frames: {res.frames}")
    print(f"  Bitstream: {args.bitstream} ({res.bytes_written} bytes)")
    print(f"  Mean Y-PSNR: {res.mean_psnr_y:.2f} dB")
    tp = res.stats["throughput"]
    print(f"  Throughput: {tp['mpix_per_s']:.2f} Mpix/s "
          f"({tp['pixels']/1e6:.1f} Mpix in {tp['seconds']:.2f}s)")
    rc = res.stats.get("rate_control")
    if rc:
        print(f"  Rate control: target {rc['target_bpp']:.3f} bpp -> "
              f"achieved {rc['achieved_bpp']:.3f} bpp "
              f"(QP {rc['qp_start']} -> {rc['qp_final']})")
    for stage, s in res.stats.items():
        if stage not in ("throughput", "rate_control"):
            print(f"    {stage:8s} {s['total_s']:8.3f}s over {s['calls']} calls")
    if args.hevc_export:
        _export_sequence(args, config)


def _export_sequence(args: argparse.Namespace, config) -> None:
    """The whole sequence as one standard-syntax stream: an IDR access
    unit a frame, from the container bitstream (no re-encode)."""
    from nanohevc_tpu_torch.models.sequence import decode_sequence_levels
    from nanohevc_tpu_torch.runtime.hevc_stream import HevcStreamWriter

    writer = HevcStreamWriter(
        args.height, args.width, config.block_size, config.qp,
        bit_depth=config.bit_depth, chroma420=not args.hevc_mono,
    )
    nc = config.chroma_block_size()
    for fr in decode_sequence_levels(args.bitstream):
        fqp = fr["Y"].get("qp", config.qp)
        ly, my = _plane_raster(fr, "Y", config.block_size, config.scan)
        if args.hevc_mono:
            writer.add_frame(ly, my, qp=fqp)
            continue
        lu, mu = _plane_raster(fr, "U", nc, config.scan)
        lvv, mv = _plane_raster(fr, "V", nc, config.scan)
        if not np.array_equal(mu, mv):
            print(f"Error: {_MODES_DIFFER}", file=sys.stderr)
            sys.exit(1)
        writer.add_frame(ly, my, lu, lvv, mu, qp=fqp)
    stream = writer.bytes()
    with open(args.hevc_export, "wb") as f:
        f.write(stream)
    kind = "luma, monochrome" if args.hevc_mono else "4:2:0 YUV"
    print(f"  HEVC export ({kind} Annex B, {writer.frames} IDR "
          f"AUs): {args.hevc_export} ({len(stream)} bytes)")


def cmd_decode(args: argparse.Namespace) -> None:
    """Decode a closed-loop bitstream (one frame, or a sequence behind
    access-unit delimiters) to YUV420p."""
    from nanohevc_tpu_torch.models.sequence import NAL_AUD, decode_sequence
    from nanohevc_tpu_torch.models.wavefront import decode_frame
    from nanohevc_tpu_torch.runtime.bitstream import _split_nals, parse_bitstream

    with open(args.input, "rb") as f:
        bitstream = f.read()
    # multi-frame sequence streams carry AUD NALs; single frames don't
    is_sequence = any(t == NAL_AUD for t, _ in _split_nals(bitstream))
    try:
        if is_sequence:
            n = decode_sequence(args.input, args.output, device=args.device)
            print(f"Decoded: {args.input} -> {args.output} ({n} frames)")
        else:
            frame = decode_frame(bitstream, device=args.device)
            params = parse_bitstream(bitstream).get("params", {})
            depth = 8 + params.get("bit_depth_luma_minus8", 0)
            with open(args.output, "wb") as f:
                f.write(frame.to_yuv420p(bit_depth=depth))
            suffix = "" if depth == 8 else f", {depth}-bit 16le samples"
            print(f"Decoded: {args.input} -> {args.output} "
                  f"({frame.width}x{frame.height}{suffix})")
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


def assemble_frame_bitstream(width: int, height: int, config, info: dict) -> bytes:
    """The NAL-framed container bitstream of an encode_frame_full result,
    written by the host runtime (`runtime.assemble_bitstream`)."""
    from nanohevc_tpu_torch.runtime import assemble_bitstream

    planes = {
        name: (p["levels"], p["block_size"])
        for name, p in info["planes"].items()
    }
    modes = {name: p["modes"] for name, p in info["planes"].items()}
    return assemble_bitstream(
        width, height, config.qp, planes, modes,
        bit_depth=config.bit_depth, scan=config.scan,
        dequant_rescale=config.dequant_rescale,
        intra_smoothing=config.intra_smoothing,
        entropy_coder=config.entropy_coder,
    )


def _add_filter_and_export_flags(sub: argparse.ArgumentParser,
                                 what: str) -> None:
    """The in-loop filter and standard-export flags of `encode` and
    `encode-seq` (`what`: "frame" or "sequence")."""
    sub.add_argument(
        "--deblock", action="store_true",
        help="in-loop deblocking filter (spec 8.7.2) on the decodable "
        "reconstruction (closed loop only); carried in the PPS",
    )
    sub.add_argument(
        "--sao", action="store_true",
        help="sample adaptive offset (spec 8.7.3) after deblocking: "
        "per-plane parameters estimated per frame, carried in a SAO NAL "
        "(closed loop only)",
    )
    sub.add_argument(
        "--sao-ctb", action="store_true",
        help="CTB-granular SAO: per-tile parameters chosen by RD cost "
        "with merge flags, in a bit-packed SAO NAL (closed loop only; "
        "excludes --sao)",
    )
    sub.add_argument(
        "--sao-tile", type=int, default=64,
        help="CTB tile size in samples for --sao-ctb (power of two, "
        "default 64)",
    )
    sub.add_argument(
        "--hevc-export", metavar="PATH", default=None,
        help=f"also export the {what} as a standalone standard-syntax "
        "HEVC stream (Annex B; 4:2:0 by default, --hevc-mono for luma "
        "only; closed loop only, block size >= 8, no in-loop filter), "
        "built from the container bitstream without a second encode",
    )
    sub.add_argument(
        "--hevc-mono", action="store_true",
        help="--hevc-export writes a monochrome (luma-only) stream",
    )
    sub.add_argument(
        "--chroma-mode", choices=("dc", "planar"), default=None,
        help="fix the chroma planes' intra mode (no search); dc by "
        "default under --hevc-export (the spec signals one chroma mode "
        "per CU)",
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="nanohevc_tpu_torch",
        description="HEVC all-intra encoder, PyTorch/CUDA port",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on: cuda (default; fails without a "
        "card, never falls back) or cpu (plain PyTorch versions of "
        "the kernels)",
    )
    parser.add_argument("--platform", default=None, help=argparse.SUPPRESS)
    sub = parser.add_subparsers(dest="command", required=True)

    demo = sub.add_parser("demo", help="Run demo with synthetic test frame")
    demo.add_argument("--width", type=int, default=64, help="Frame width")
    demo.add_argument("--height", type=int, default=64, help="Frame height")
    demo.add_argument("--block-size", type=int, default=8, help="Block size (4,8,16,32)")
    demo.set_defaults(func=cmd_demo)

    enc = sub.add_parser("encode", help="Encode a YUV420p file")
    enc.add_argument("input", help="Input YUV420p file")
    enc.add_argument("--width", type=int, required=True, help="Frame width")
    enc.add_argument("--height", type=int, required=True, help="Frame height")
    enc.add_argument("--block-size", type=int, default=8, help="Block size")
    enc.add_argument("-o", "--output", help="Output reconstructed YUV file")
    enc.add_argument("--qp", type=int, default=22, help="Quantization parameter 0-51")
    enc.add_argument(
        "--scan", choices=("diag", "horizontal", "vertical", "mode"),
        default="diag", help="coefficient scan (spec 6.5.3 / 7.4.9.11)",
    )
    enc.add_argument(
        "--decision", choices=("energy", "satd", "sad", "rd"), default=None,
        help="mode-decision cost override; default follows --mode-search",
    )
    enc.add_argument(
        "--entropy", choices=("range", "cabac", "hevc-slice"),
        default="range", help="slice entropy engine of the host runtime",
    )
    enc.add_argument(
        "--pipeline", choices=("predict", "full", "closed-loop"),
        default="predict",
        help="predict = prediction-only; full = predict+transform+quant+"
        "recon (open loop); closed-loop = reconstruction-fed wavefront "
        "(decodable)",
    )
    enc.add_argument(
        "--bitstream",
        help="write the NAL-framed bitstream to this path (full or "
        "closed-loop pipeline)",
    )
    enc.add_argument(
        "--dequant-rescale", action="store_true",
        help="spec-correct dequant size rescale at N>4 (PPS-carried)",
    )
    enc.add_argument(
        "--mode-search", action="store_true",
        help="search all 35 intra modes (SATD) instead of DC/planar energy "
        "(full or closed-loop pipeline)",
    )
    enc.add_argument(
        "--intra-smoothing", action="store_true",
        help="[1 2 1] reference-sample smoothing per spec 8.4.4.2.3 "
        "(luma, N>=8); carried in the PPS",
    )
    enc.add_argument(
        "--rdo", action="store_true",
        help="RD-optimized coded-block-flag decision (full pipeline)",
    )
    enc.add_argument(
        "--rdoq", action="store_true",
        help="rate-distortion optimized quantization: re-decide levels "
        "under D + lambda*R (full and closed-loop pipelines; the closed "
        "loop reconstructs from the adjusted levels, so decode stays "
        "pixel-exact)",
    )
    enc.add_argument(
        "--target-bytes", type=int, default=None,
        help="rate search: pick the lowest QP whose coded frame fits "
        "this many bytes (bisection over real coder sizes; full and "
        "closed-loop pipelines)",
    )
    _add_filter_and_export_flags(enc, "frame")
    enc.set_defaults(func=cmd_encode)

    seq = sub.add_parser(
        "encode-seq", help="Encode a multi-frame YUV420p sequence to a bitstream"
    )
    seq.add_argument("input", help="Input YUV420p sequence file")
    seq.add_argument("--width", type=int, required=True)
    seq.add_argument("--height", type=int, required=True)
    seq.add_argument("--frames", type=int, required=True, help="Frames to encode")
    seq.add_argument("--block-size", type=int, default=8)
    seq.add_argument("--qp", type=int, default=22)
    seq.add_argument("--batch", type=int, default=8, help="Frames per device batch")
    seq.add_argument("--bitstream", required=True, help="Output bitstream path")
    seq.add_argument(
        "--scan", choices=("diag", "horizontal", "vertical", "mode"),
        default="diag", help="coefficient scan order (see encode --scan)",
    )
    seq.add_argument(
        "--decision", choices=("energy", "satd", "sad", "rd"), default=None,
        help="mode-decision cost override (see encode --decision)",
    )
    seq.add_argument(
        "--entropy", choices=("range", "cabac", "hevc-slice"),
        default="range", help="slice entropy engine (see encode --entropy)",
    )
    seq.add_argument("--mode-search", action="store_true")
    seq.add_argument("--rdo", action="store_true",
                     help="RD-optimized coded-block-flag decision")
    seq.add_argument("--rdoq", action="store_true",
                     help="rate-distortion optimized quantization "
                     "(open- and closed-loop; see encode --rdoq)")
    seq.add_argument("--entropy-tiles", type=int, default=1,
                     help="parallel host entropy: split each plane's "
                     "levels into N independent context chunks coded "
                     "on N threads (HEVC tiles/WPP analog)")
    seq.add_argument("--target-bpp", type=float, default=None,
                     help="one-pass rate control: target bits per luma "
                     "pixel (QP adapts between batches; --qp seeds it)")
    seq.add_argument("--intra-smoothing", action="store_true",
                     help="[1 2 1] reference smoothing (PPS-carried)")
    seq.add_argument("--dequant-rescale", action="store_true",
                     help="spec-correct dequant size rescale (PPS-carried)")
    seq.add_argument("--closed-loop", action="store_true",
                     help="reconstruction-fed wavefront encode "
                          "(stream decodable to pixels)")
    seq.add_argument(
        "--no-resume", action="store_true",
        help="ignore existing progress sidecar and start over",
    )
    seq.add_argument("--report-every", type=int, default=0)
    _add_filter_and_export_flags(seq, "sequence")
    seq.set_defaults(func=cmd_encode_seq)

    dec = sub.add_parser(
        "decode", help="Decode a closed-loop bitstream to YUV420p"
    )
    dec.add_argument("input", help="Input bitstream file")
    dec.add_argument("-o", "--output", required=True, help="Output YUV path")
    dec.set_defaults(func=cmd_decode)

    args = parser.parse_args(argv)
    if args.platform is not None:
        parser.error("--platform chooses a JAX backend, which this package "
                     "does not use; choose the torch device with --device")
    if args.command in ("demo", "encode", "encode-seq", "decode"):
        from nanohevc_tpu_torch import resolve_device

        try:
            args.device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            sys.exit(1)
    args.func(args)


if __name__ == "__main__":
    main()
