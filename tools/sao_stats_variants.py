"""Time the SAO statistics kernel (`csrc/sao.cu`) against variants of
its design, on the card.

    python3 tools/sao_stats_variants.py      # from the root of a checkout

Variants, each built from an edited copy of this tree's `csrc/`
(`kernels/build.py::edited_copy`) and called through its own
`nhv_sao_stats`:

- `threads 256` / `threads 512`: fewer threads a thread block, so more
  serial iterations over a tile's samples (256: the kernel's first
  design);
- `lanes summed first`: the lanes of one key summed first
  (`__match_any_sync`, `__reduce_add_sync`) so that one lane a key adds
  to the warp's histogram, over a warp-uniform loop (the first design's
  histogram);
- both together (the first design).

Each is checked against this tree's kernel (the same statistics) and
timed through a CUDA graph on the padded 1080p luma and chroma planes
of the default config's closed-loop recon at tiles of 64 (CTB SAO's
default and per-plane SAO's), in turns: kernel, variants, kernel.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch.kernels import build  # noqa: E402
from nanohevc_tpu_torch.kernels import loop_filter as lf  # noqa: E402

THREADS = "constexpr int kStatThreads = 1024;"
HIST_ADD = """__device__ __forceinline__ void hist_add(int* cnt, int* sum, int key,
                                         int val) {
  atomicAdd(cnt + key, 1);
  atomicAdd(sum + key, val);
}"""
WARP_HIST_ADD = HIST_ADD + """
__device__ __forceinline__ void warp_hist_add(int* cnt, int* sum, int key,
                                              int val) {
  const unsigned peers = __match_any_sync(kFull, key);
  const int total = __reduce_add_sync(peers, val);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(cnt + key, __popc(peers));
    atomicAdd(sum + key, total);
  }
}"""
LOOP = """  for (int i = threadIdx.x; i < n; i += kStatThreads) {
    const int y = y0 + i / tw, x = x0 + i % tw;
    const int p = __ldg(r + (long long)y * width + x);
    const int d = __ldg(s + (long long)y * width + x) - p;
    const int band = p >> (bit_depth - 5);
    if (band >= 0 && band < 32) hist_add(h + kBoCnt, h + kBoSum, band, d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cat = eo_category(r, height, width, y, x, p, c);
      if (cat) hist_add(h + kEoCnt, h + kEoSum, c * 4 + cat - 1, d);
    }
  }"""
WARP_LOOP = """  for (int first = 0; first < n; first += kStatThreads) {
    const int i = first + threadIdx.x;
    const bool valid = i < n;
    int y = 0, x = 0, p = 0, d = 0;
    if (valid) {
      y = y0 + i / tw;
      x = x0 + i % tw;
      p = __ldg(r + (long long)y * width + x);
      d = __ldg(s + (long long)y * width + x) - p;
    }
    const int band = p >> (bit_depth - 5);
    warp_hist_add(h + kBoCnt, h + kBoSum,
                  valid && band >= 0 && band < 32 ? band : -1, d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cat = valid ? eo_category(r, height, width, y, x, p, c) : 0;
      warp_hist_add(h + kEoCnt, h + kEoSum, cat ? c * 4 + cat - 1 : -1, d);
    }
  }"""
SUMMED = [("sao.cu", HIST_ADD, WARP_HIST_ADD), ("sao.cu", LOOP, WARP_LOOP)]
VARIANTS = {
    "threads 256": [("sao.cu", THREADS, THREADS.replace("1024", "256"))],
    "threads 512": [("sao.cu", THREADS, THREADS.replace("1024", "512"))],
    "lanes summed first": SUMMED,
    "lanes summed first, threads 256 (first design)": SUMMED + [
        ("sao.cu", THREADS, THREADS.replace("1024", "256"))],
}


def stats_call(lib, src, rec, tile: int):
    b, h, w = rec.shape
    nty, ntx = -(-h // tile), -(-w // tile)
    out = torch.empty((b, nty, ntx, lf.STAT_INTS), dtype=torch.int32,
                      device=rec.device)
    rc = lib.nhv_sao_stats(src.data_ptr(), rec.data_ptr(), b, h, w,
                           tile.bit_length() - 1, 8, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream, 0)
    if rc:
        raise RuntimeError(f"nhv_sao_stats failed: CUDA error {rc}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sao_stats_variants: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    libs = {"kernel": lf.cuda_kernels("sao").lib}
    root = build.BUILD_DIR / "variants"
    for k, (name, edits) in enumerate(VARIANTS.items()):
        out = root / f"v{k}"
        lib, info = build.build_copy(build.edited_copy(out, edits), "sao",
                                     out)
        libs[name] = lib
        regs = [ln.strip() for ln in info.log.splitlines()
                if "registers" in ln]
        cs.log(f"built {name} in {info.seconds:.2f} s: {regs}")
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    for name, src, rec, _ in cs.filter_planes(dev, frame):
        deb = lf.deblock_planes(rec, 22, 8, name != "Y")
        want = stats_call(libs["kernel"], src, deb, 64)
        for label, lib in libs.items():
            if not torch.equal(stats_call(lib, src, deb, 64), want):
                raise SystemExit(f"{label}: statistics differ on {name}")
        order = list(libs) + ["kernel"]
        times = {}
        for label in order:
            ms = cs.graph_ms(lambda lib=libs[label]: stats_call(
                lib, src, deb, 64))
            times.setdefault(label, []).append(ms)
        cs.log(f"{name} {tuple(rec.shape[1:])}, tile 64, ms (CUDA graph; "
               f"outputs equal): " + ", ".join(
                   f"{k} {'/'.join(f'{t:.4f}' for t in v)}"
                   for k, v in times.items()) + f" [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
