"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main paths on a seeded 1080p 4:2:0 frame, the
open-loop all-intra encode and the closed-loop (wavefront) encode with
its decoder, each with the default EncoderConfig (8x8 luma, 4x4
chroma, QP 22, DC/planar by energy) and with the 35-mode SATD search
(mode_set="all", decision="satd", what the CLI's --mode-search
selects), and checks them end to end:

1. the card, its power limit, and the PyTorch and CUDA versions;
2. builds the CUDA kernels from the sources in this checkout, one nvcc
   per source, all at once;
3. holds the slab kernel (3) and the mode-search kernel (3b) against
   their plain PyTorch versions on the card, exactly, over N 4/8/16/32,
   DST at 4, 8/10-bit, both dequant modes and QP 0/22/37/51, on a
   1080x1920 luma and a 540x960 chroma plane, and at N 4/8 on a 45x200
   plane that leaves thread blocks part empty; and the wavefront kernel
   (3c), both bodies, over the same N, bit depths, dequant modes and
   QPs at batch 1 and 2 on a 540x960 and a padded 45x200 plane, and at
   N 4 DST, 8 and 16 (padded to 1088 rows) on 1080x1920;
4. encodes the frame on the card under each config through the open
   loop (4: default, 4b: mode search) and the closed loop (4c, 4d):
   the path's kernel must launch once per plane (3 times) and every
   other kernel not at all, the result must equal the port's plain
   path on the CPU, 256 sampled luma blocks must match the numpy
   oracle (for the closed loop, a per-block simulation on the
   reconstructed neighbours), and the bitstream written by the port's
   runtime must parse back to the same levels and modes; the closed
   loop's stream must decode on the card to the recon pixel for pixel;
5. runs the CLI on the same frame under each config and compares its
   bitstream (5, 5b: open loop; 5c: closed loop, then `decode`);
6. times kernels and plain versions per 1080p luma plane, the frame
   under each config, and the closed-loop frame and its decode (6c).

Prints one JSON line of kernel results before the last line, and as the
last line {"ok": true, "device": {...}}.  Exits non-zero, without that
line, when there is no CUDA card or a phase fails.

Each kernel's bound in the JSON line is the larger of its bytes over
the card's 3.35 TB/s and its integer operations over 67 T/s (the H100
SXM's float32 rate outside the tensor cores, which no int32 add or
multiply exceeds), counted per pixel as `kernel_bound` says.
"""

from __future__ import annotations

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
    from nanohevc_tpu_torch.models.all_intra import (
        encode_frame_full,
        encode_plane_config,
    )
    from nanohevc_tpu_torch.models.wavefront import (
        decode_frame,
        encode_frame_closed_loop,
        encode_planes_closed_loop,
        pad_to_blocks,
        plane_args,
    )
    from nanohevc_tpu_torch.ref.metrics import hadamard_matrix
    from nanohevc_tpu_torch.ref.metrics import ssim as ssim_host
    from nanohevc_tpu_torch.runtime import assemble_bitstream, parse_bitstream
except ImportError as exc:
    print(f"chip_smoke: cannot import the port ({exc}); run it from the "
          "root of a checkout of the repository", file=sys.stderr)
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 1080, 1920
SEED = 0
MODE_SEARCH = EncoderConfig(mode_set="all", decision="satd")
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
        "nanohevc_tpu/kernels/wavefront_slab.py:151",
    ),
}
# The wavefront kernel's two bodies, by (mode_set, decision).
WAVEFRONT_BODIES = {"dc_planar": ("dc_planar", "energy"),
                    "search": ("all", "satd")}


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


def cold_l2_ms(fn, dev, iters: int = 10) -> float:
    """Mean device time of fn() with the 50 MB L2 overwritten before each
    launch (a 256 MB memset), so its inputs come from HBM."""
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    fn()
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def max_abs_err(got: dict, want: dict) -> int:
    return max(
        int((got[k].long() - want[k].long()).abs().max()) if want[k].numel() else 0
        for k in want
    )


def phase_kernel_vs_plain(dev, name: str, tag: str) -> int:
    kernel, plain = KERNELS[name][:2]
    rng = np.random.default_rng(SEED)
    worst = 0
    cases = 0
    # The 45x200 plane leaves the last thread block of N=4 and N=8 part
    # empty (its block count is no multiple of 16 or 4).
    for shape in ((H, W), (H // 2, W // 2), (45, 200)):
        for bit_depth in (8, 10):
            plane = torch.from_numpy(textured(*shape, bit_depth, rng)).to(dev)
            for n, use_dst in ((4, False), (4, True), (8, False),
                               (16, False), (32, False)):
                if shape[1] % n:
                    continue
                for rescale in (False, True):
                    for qp in (0, 22, 37, 51):
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
        f"(max abs err {worst})")
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
    for name in KERNELS:
        KERNELS[name][0].launches = 0
    t0 = time.perf_counter()
    recon, info = encode_frame_full(frame, config, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: KERNELS[name][0].launches for name in KERNELS}
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
        k_ms = cuda_ms(lambda: kernel(y, 22, n, use_dst=use_dst))
        p_ms = cuda_ms(lambda: plain(y, 22, n, use_dst=use_dst), iters=5)
        times[n] = (k_ms, p_ms)
        log(f"[{tag}] {name} 1080p luma N={n}{' DST' if use_dst else ''}: "
            f"kernel {k_ms:.4f} ms ({mpix / k_ms * 1e3:.1f} Mpix/s), plain "
            f"{p_ms:.4f} ms ({mpix / p_ms * 1e3:.1f} Mpix/s) [{gpu}]")
    if name == "slab_encode_plane":
        cold = cold_l2_ms(lambda: kernel(y, 22, 8), dev)
        log(f"[{tag}] {name} 1080p luma N=8 with L2 flushed before each "
            f"launch: {cold:.4f} ms ({mpix / cold * 1e3:.1f} Mpix/s, "
            f"{12 * H * W / cold / 1e6:.1f} GB/s at 12 B/pixel) [{gpu}]")
    return times


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


def device_busy(call):
    """(device-busy us, wall us) of three call()s under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
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
    planar and DC.  No step of these kernels depends on the data.
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
    the QPs so that each QP meets every combination across the N."""
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
    log(f"[3c] wavefront_encode_planes == plain on CUDA in {len(cases)} "
        f"cases (max abs err {worst})")
    return worst


def phase_closed_loop(dev, frame: Frame, config: EncoderConfig, tag: str):
    """Closed-loop encode of the frame on the card: the wavefront kernel
    must launch 3 times and every other kernel 0 times; the result must
    equal the plain path on the CPU and the per-block simulation, parse
    back, and decode on the card to the recon pixel for pixel."""
    for name in KERNELS:
        KERNELS[name][0].launches = 0
    t0 = time.perf_counter()
    recon, bits = encode_frame_closed_loop(frame, config, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: KERNELS[name][0].launches for name in KERNELS}
    log(f"[{tag}] encode_frame_closed_loop on {dev}: {first_s:.3f} s (first "
        f"call), kernel launches {launches}")
    want = {name: 3 if name == "wavefront_encode_planes" else 0
            for name in KERNELS}
    if launches != want:
        raise SystemExit(f"closed loop launched {launches}, expected {want} "
                         "(Y, U, V through the wavefront kernel)")

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
    decoded = decode_frame(bits, device=dev)
    dec_s = time.perf_counter() - t0
    if not all(np.array_equal(getattr(recon, p).data, getattr(decoded, p).data)
               for p in "yuv"):
        raise SystemExit("decode_frame on the card differs from the recon")
    y_psnr = oracle.psnr(frame.y.data.astype(np.uint8),
                         recon.y.data.astype(np.uint8))
    log(f"[{tag}] decode_frame on {dev} == encoder recon pixel for pixel "
        f"({dec_s:.3f} s, first call); Y-PSNR {y_psnr:.2f} dB")
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
            k_ms = cuda_ms(lambda: kernel(y, 22, n, **kw), iters=10)
            p_ms = cuda_ms(lambda: plain(y, 22, n, **kw), iters=1, warmup=1)
            times[body, n] = (k_ms, p_ms)
            log(f"[6c] wavefront_encode_planes {body} 1080p luma N={n}"
                f"{' DST' if n == 4 else ''}: kernel {k_ms:.4f} ms "
                f"({mpix / k_ms * 1e3:.1f} Mpix/s; {depth} dependent "
                f"launches, {1e3 * k_ms / depth:.2f} us each), plain "
                f"{p_ms:.4f} ms ({mpix / p_ms * 1e3:.1f} Mpix/s) [{gpu}]")
    return times


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
        planes = [torch.from_numpy(p.data.astype(np.int32))[None].to(dev)
                  for p in (frame.y, frame.u, frame.v)]
        torch.cuda.synchronize()
        out["h2d"] = clock() - t0
        t0 = clock()
        res = [encode_planes_closed_loop(p, config.qp,
                                         **plane_args(config, i == 0))
               for i, p in enumerate(planes)]
        torch.cuda.synchronize()
        out["device"] = clock() - t0
        t0 = clock()
        host = [{k: v[0].cpu().numpy() for k, v in r.items()} for r in res]
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
        "slab_encode_plane": phase_kernel_vs_plain(dev, "slab_encode_plane", "3"),
        "mode_search_encode_plane": phase_kernel_vs_plain(
            dev, "mode_search_encode_plane", "3b"),
        "wavefront_encode_planes": phase_wavefront_vs_plain(dev),
    }
    frame = make_frame(np.random.default_rng(SEED))
    config = EncoderConfig()
    launches = {}
    launches["slab_encode_plane"], bits = phase_main_path(
        dev, frame, config, "slab_encode_plane", "4")
    launches["mode_search_encode_plane"], ms_bits = phase_main_path(
        dev, frame, MODE_SEARCH, "mode_search_encode_plane", "4b")
    # The wavefront kernel's main paths are both closed-loop configs.
    cl_launches, cl_bits, cl_recon = phase_closed_loop(dev, frame, config, "4c")
    ms_launches, ms_cl_bits, ms_cl_recon = phase_closed_loop(
        dev, frame, MODE_SEARCH, "4d")
    launches["wavefront_encode_planes"] = cl_launches + ms_launches
    phase_cli(frame, bits, [], "5")
    phase_cli(frame, ms_bits, ["--mode-search"], "5b")
    phase_cli_closed_loop(frame, cl_bits, cl_recon, [], "5c")
    phase_cli_closed_loop(frame, ms_cl_bits, ms_cl_recon, ["--mode-search"],
                          "5c")
    times = {
        "slab_encode_plane": kernel_times(dev, "slab_encode_plane", "6", gpu),
        "mode_search_encode_plane": kernel_times(
            dev, "mode_search_encode_plane", "6b", gpu),
    }
    wf = wavefront_times(dev, gpu)
    times["wavefront_encode_planes"] = {n: wf["dc_planar", n] for n in (8,)}
    frame_times(dev, frame, config, "default config:", gpu)
    frame_times(dev, frame, MODE_SEARCH, "mode search:", gpu)
    closed_loop_times(dev, frame, config, "default config:", gpu)
    closed_loop_times(dev, frame, MODE_SEARCH, "mode search:", gpu)

    # ms and bounds at the main path's shape: a 1080p luma plane at N = 8
    # (the wavefront kernel: its DC/planar body, the default config's).
    searches = {"slab_encode_plane": False, "mode_search_encode_plane": True,
                "wavefront_encode_planes": False}
    entries = []
    for name, (_, _, source, replaces) in KERNELS.items():
        k_ms, p_ms = times[name][config.block_size]
        bound_ms, bound_by = kernel_bound(searches[name], config.block_size,
                                          H * W)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,    # no one PyTorch call encodes a plane
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
