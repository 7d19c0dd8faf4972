"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main path, the open-loop all-intra encode of a seeded
1080p 4:2:0 frame with the default EncoderConfig (8x8 luma, 4x4 chroma,
QP 22, DC/planar by energy), and checks it end to end:

1. the card, its power limit, and the PyTorch and CUDA versions;
2. builds the CUDA kernels from the sources in this checkout;
3. holds the slab kernel against its plain PyTorch version on the card,
   exactly, over N 4/8/16/32, DST at 4, 8/10-bit, both dequant modes
   and QP 0/22/37/51, on a 1080x1920 luma and a 540x960 chroma plane;
4. encodes the frame on the card: the kernel must launch once per plane
   (3 times), the result must equal the port's plain path on the CPU,
   256 sampled luma blocks must match the numpy oracle, and the
   bitstream written by the shared runtime must parse back to the same
   levels and modes;
5. runs the CLI on the same frame and compares its bitstream;
6. times kernel and plain version per 1080p luma plane, and the frame.

Prints one JSON line of kernel results before the last line, and as the
last line {"ok": true, "device": {...}}.  Exits non-zero, without that
line, when there is no CUDA card or a phase fails.
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

    from nanohevc_tpu import ref as oracle
    from nanohevc_tpu.config import EncoderConfig
    from nanohevc_tpu.frame import Frame, Plane
    from nanohevc_tpu.ref.metrics import ssim as ssim_host
    from nanohevc_tpu.runtime import parse_bitstream
    from nanohevc_tpu_torch.cli import assemble_frame_bitstream
    from nanohevc_tpu_torch.kernels import build
    from nanohevc_tpu_torch.kernels.slab_pipeline import (
        slab_encode_plane,
        slab_encode_plane_reference,
    )
    from nanohevc_tpu_torch.models.all_intra import (
        encode_frame_full,
        encode_plane_config,
    )
except ImportError as exc:
    print(f"chip_smoke: cannot import the port ({exc}); run it from the "
          "root of a checkout of the repository", file=sys.stderr)
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 1080, 1920
SEED = 0
KERNEL_SOURCE = "nanohevc_tpu_torch/csrc/slab_pipeline.cu"
TPU_KERNEL = "nanohevc_tpu/kernels/slab_pipeline.py:275"


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


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over iters launches, after warm-up."""
    for _ in range(3):
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


def phase_kernel_vs_plain(dev) -> int:
    rng = np.random.default_rng(SEED)
    worst = 0
    cases = 0
    for shape in ((H, W), (H // 2, W // 2)):
        for bit_depth in (8, 10):
            plane = torch.from_numpy(textured(*shape, bit_depth, rng)).to(dev)
            for n, use_dst in ((4, False), (4, True), (8, False),
                               (16, False), (32, False)):
                for rescale in (False, True):
                    for qp in (0, 22, 37, 51):
                        kw = dict(bit_depth=bit_depth, use_dst=use_dst,
                                  dequant_rescale=rescale)
                        got = slab_encode_plane(plane, qp, n, **kw)
                        want = slab_encode_plane_reference(plane, qp, n, **kw)
                        torch.cuda.synchronize()
                        err = max_abs_err(got, want)
                        if err:
                            raise SystemExit(
                                f"kernel != plain at {shape} N={n} dst={use_dst} "
                                f"bd={bit_depth} rescale={rescale} qp={qp}: "
                                f"max abs err {err}")
                        worst = max(worst, err)
                        cases += 1
    log(f"[3] kernel == plain on CUDA in {cases} cases (max abs err {worst})")
    return worst


def make_frame(rng) -> Frame:
    return Frame(Plane(textured(H, W, 8, rng).astype(np.int16)),
                 Plane(textured(H // 2, W // 2, 8, rng).astype(np.int16)),
                 Plane(textured(H // 2, W // 2, 8, rng).astype(np.int16)))


def oracle_gate(plane: np.ndarray, levels: np.ndarray, recon: np.ndarray,
                n: int, qp: int) -> int:
    """Count of 256 sampled blocks that differ from the numpy oracle
    (levels (nb, N, N) raster blocks, recon (H, W))."""
    rng = np.random.default_rng(SEED)
    nbx = plane.shape[1] // n
    nb = (plane.shape[0] // n) * nbx
    bad = 0
    for b in rng.choice(nb, size=min(256, nb), replace=False):
        y0, x0 = (b // nbx) * n, (b % nbx) * n
        blk = plane[y0:y0 + n, x0:x0 + n]
        top = (np.full(n, 128, np.int16) if y0 == 0
               else plane[y0 - 1, x0:x0 + n].astype(np.int16))
        left = (np.full(n, 128, np.int16) if x0 == 0
                else plane[y0:y0 + n, x0 - 1].astype(np.int16))
        dc = oracle.intra_dc_predict(top, left, n)
        pln = oracle.intra_planar_predict(top, left, int(top[-1]),
                                          int(left[-1]), n)
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


def phase_main_path(dev, frame: Frame, config: EncoderConfig):
    slab_encode_plane.launches = 0
    t0 = time.perf_counter()
    recon, info = encode_frame_full(frame, config, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = slab_encode_plane.launches
    log(f"[4] encode_frame_full on {dev}: {first_s:.3f} s (first call), "
        f"slab kernel launches {launches}")
    if launches != 3:
        raise SystemExit(f"main path launched the slab kernel {launches} "
                         "times, expected 3 (Y, U, V)")

    cpu = encode_frame_full(frame, config, device="cpu")
    if not same_encode((recon, info), cpu):
        raise SystemExit("CUDA encode differs from the plain path on the CPU")
    log("[4] CUDA encode == plain path on the CPU (recon, levels, modes, nnz)")

    y = torch.from_numpy(frame.y.data.astype(np.int32)).to(dev)
    out = slab_encode_plane(y, config.qp, config.block_size)
    bad = oracle_gate(frame.y.data, out["levels"].cpu().numpy(),
                      out["recon"].cpu().numpy(), config.block_size, config.qp)
    if bad:
        raise SystemExit(f"{bad} of 256 sampled blocks differ from the oracle")
    log("[4] 256 sampled luma blocks == numpy oracle")

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
    log(f"[4] bitstream {len(bits)} bytes parses back to the same levels and "
        f"modes; Y-PSNR {info['psnr_y']:.2f} dB, SSIM {info['ssim_y']:.4f}")
    return launches, bits


def phase_cli(frame: Frame, bits: bytes) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "frame.yuv")
        out = os.path.join(tmp, "out.bin")
        with open(src, "wb") as f:
            f.write(frame.to_yuv420p())
        proc = subprocess.run(
            [sys.executable, "-m", "nanohevc_tpu_torch", "encode", src,
             "--width", str(W), "--height", str(H), "--pipeline", "full",
             "--bitstream", out],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise SystemExit(f"CLI failed (rc {proc.returncode}):\n{proc.stderr}")
        with open(out, "rb") as f:
            cli_bits = f.read()
    if cli_bits != bits:
        raise SystemExit("CLI bitstream differs from the library encode")
    log(f"[5] CLI encode on the GPU: rc 0, bitstream identical ({len(bits)} bytes)")


def phase_times(dev, frame: Frame, config: EncoderConfig, gpu: str) -> dict:
    rng = np.random.default_rng(SEED + 1)
    y = torch.from_numpy(textured(H, W, 8, rng)).to(dev)
    mpix = H * W / 1e6
    times = {}
    for n in (4, 8, 16, 32):
        use_dst = n == 4
        k_ms = cuda_ms(lambda: slab_encode_plane(y, 22, n, use_dst=use_dst))
        p_ms = cuda_ms(lambda: slab_encode_plane_reference(
            y, 22, n, use_dst=use_dst), iters=5)
        times[n] = (k_ms, p_ms)
        log(f"[6] 1080p luma N={n}{' DST' if use_dst else ''}: kernel "
            f"{k_ms:.4f} ms ({mpix / k_ms * 1e3:.1f} Mpix/s), plain "
            f"{p_ms:.4f} ms ({mpix / p_ms * 1e3:.1f} Mpix/s) [{gpu}]")

    cold = cold_l2_ms(lambda: slab_encode_plane(y, 22, 8), dev)
    log(f"[6] 1080p luma N=8 kernel with L2 flushed before each launch: "
        f"{cold:.4f} ms ({mpix / cold * 1e3:.1f} Mpix/s, "
        f"{12 * H * W / cold / 1e6:.1f} GB/s at 12 B/pixel) [{gpu}]")

    planes = [torch.from_numpy(p.data.astype(np.int32)).to(dev)
              for p in (frame.y, frame.u, frame.v)]
    dev_ms = cuda_ms(lambda: [encode_plane_config(p, config, i == 0)
                              for i, p in enumerate(planes)])
    log(f"[6] 1080p 4:2:0 frame, device part (3 planes resident, kernel + "
        f"scan-pack): {dev_ms:.4f} ms ({mpix / dev_ms * 1e3:.1f} Mpix/s luma) "
        f"[{gpu}]")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        encode_frame_full(frame, config, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * sorted(walls)[len(walls) // 2]
    log(f"[6] 1080p 4:2:0 encode_frame_full (host in, host out, PSNR/SSIM "
        f"included), median of 5: {wall_ms:.2f} ms "
        f"({mpix / wall_ms * 1e3:.2f} Mpix/s luma) [{gpu}]")
    stages = [frame_breakdown(dev, frame, config) for _ in range(5)]
    parts = ", ".join(
        f"{k} {1e3 * sorted(s[k] for s in stages)[2]:.2f}" for k in stages[0]
    )
    log(f"[6] where the frame's time goes, ms (host clock, median of 5): "
        f"{parts} [{gpu}]")
    busy_us, wall_us = device_busy(dev, frame, config)
    share = (f"{100 * busy_us / wall_us:.3f} % busy, "
             f"{100 - 100 * busy_us / wall_us:.3f} % idle" if busy_us
             else "not measured (the profiler recorded no device activity)")
    log(f"[6] device over 3 encode_frame_full calls (torch.profiler): "
        f"{busy_us:.1f} us of kernels and copies in {wall_us:.1f} us: "
        f"{share} [{gpu}]")
    return times


def device_busy(dev, frame: Frame, config: EncoderConfig):
    """(device-busy us, wall us) of three frame calls under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            encode_frame_full(frame, config, device=dev)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(gpu)        # as nvidia-smi prints it: name, power limit
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    info = build.build_library()
    log(f"[2] built {os.path.relpath(info.path, ROOT)} in {info.seconds:.2f} s"
        f"{' (cached)' if info.cached else ''}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2]   {line.strip()}")

    worst = phase_kernel_vs_plain(dev)
    rng = np.random.default_rng(SEED)
    frame = make_frame(rng)
    config = EncoderConfig()
    launches, bits = phase_main_path(dev, frame, config)
    phase_cli(frame, bits)
    times = phase_times(dev, frame, config, gpu)

    k_ms, p_ms = times[config.block_size]
    print(json.dumps({"kernels": [{
        "name": "slab_encode_plane",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
