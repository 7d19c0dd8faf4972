"""Command-line interface: `python -m nanohevc_tpu_torch [--device cuda|cpu]
demo|encode|decode`.

Output text and files equal those of `python -m nanohevc_tpu` for the
same arguments.  Ported: the open-loop slice (DC/planar, the 35-mode
search, reference smoothing), the closed loop (`encode --pipeline
closed-loop`) and `decode` of single-frame streams.  The flags and
commands of the JAX CLI that need anything else exit with rc 2 and a
"not yet ported" message; nothing runs in their place.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# JAX-CLI flags of `encode` that need code not ported yet, by dest.
_REFUSED_ENCODE_SWITCHES = (
    "rdo", "rdoq", "deblock", "sao", "sao_ctb", "hevc_mono",
)
_REFUSED_ENCODE_VALUES = (
    "target_bytes", "sao_tile", "hevc_export", "chroma_mode",
)
# NAL type of the access-unit delimiters that mark a multi-frame
# sequence stream (nanohevc_tpu/models/sequence.py, not ported yet).
NAL_AUD = 35


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
        dequant_rescale=args.dequant_rescale,
        intra_smoothing=args.intra_smoothing,
    )
    if args.pipeline == "closed-loop":
        encode_closed_loop(frame, config, args)
        return
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


def encode_closed_loop(frame, config, args: argparse.Namespace) -> None:
    """`encode --pipeline closed-loop`: the decodable wavefront encode."""
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


def _decode_command(parser: argparse.ArgumentParser):
    def cmd_decode(args: argparse.Namespace) -> None:
        """Decode a single-frame closed-loop bitstream to YUV420p."""
        from nanohevc_tpu_torch.models.wavefront import decode_frame
        from nanohevc_tpu_torch.runtime.bitstream import (
            _split_nals,
            parse_bitstream,
        )

        with open(args.input, "rb") as f:
            bitstream = f.read()
        if any(t == NAL_AUD for t, _ in _split_nals(bitstream)):
            _not_ported(parser, "decoding a multi-frame sequence stream")
        try:
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
    return cmd_decode


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


def _not_ported(parser: argparse.ArgumentParser, what: str) -> None:
    parser.error(f"{what} is not yet ported to nanohevc_tpu_torch")


def _refuse_command(parser):
    def run(args: argparse.Namespace) -> None:
        _not_ported(parser, f"the {args.command!r} command")
    return run


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
        help="mode-decision cost override; default follows --mode-search "
        "(rd is not ported yet)",
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
    for dest in _REFUSED_ENCODE_SWITCHES:
        enc.add_argument("--" + dest.replace("_", "-"), action="store_true",
                         help=argparse.SUPPRESS)
    for dest in _REFUSED_ENCODE_VALUES:
        enc.add_argument("--" + dest.replace("_", "-"), default=None,
                         help=argparse.SUPPRESS)
    enc.set_defaults(func=cmd_encode)

    seq = sub.add_parser("encode-seq", help="(encode-seq is not ported yet)")
    seq.add_argument("rest", nargs=argparse.REMAINDER)
    seq.set_defaults(func=_refuse_command(parser))

    dec = sub.add_parser(
        "decode", help="Decode a closed-loop bitstream to YUV420p"
    )
    dec.add_argument("input", help="Input bitstream file")
    dec.add_argument("-o", "--output", required=True, help="Output YUV path")
    dec.set_defaults(func=_decode_command(parser))

    args = parser.parse_args(argv)
    if args.platform is not None:
        _not_ported(parser, "--platform (a JAX backend flag; use --device)")
    if args.command == "encode":
        for dest in _REFUSED_ENCODE_SWITCHES + _REFUSED_ENCODE_VALUES:
            if getattr(args, dest) not in (None, False):
                _not_ported(parser, "--" + dest.replace("_", "-"))
        if args.decision == "rd":
            _not_ported(parser, "--decision rd")
    if args.command in ("demo", "encode", "decode"):
        from nanohevc_tpu_torch import resolve_device

        try:
            args.device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            sys.exit(1)
    args.func(args)


if __name__ == "__main__":
    main()
