"""Where a block's time goes in the wavefront kernel, by stage, on one card.

    python3 tools/wavefront_stages.py      # from the root of a checkout

Copies `nanohevc_tpu_torch/csrc/` into `build/wavefront_stages/csrc`,
adds clock64() stamps to the copy of `wavefront.cu` (thread 0 of each
thread block, at each stage boundary of every block, summed per thread
block and added up on the device at its end), builds it with the
package's own build code into `build/wavefront_stages/`, and runs the
wrapper on seeded 1080p luma planes (batch 1 and 8, both bodies, N 4-32).
Prints the mean SM cycles a block spends in each stage, as thread 0
sees it:

  wait+top   the top arm: the flag wait (thread 0) and the __ldcg reads
  left+bar   the left arm from registers, and the barrier before the body
  decide     the DC/planar decision (DC/planar body); the DC value
             (search body); the smoothing, where it is on
  passes     the search's passes over the modes
  winner     the search's (cost, mode) minimum across groups and warps
  predict    the winner's prediction, per pixel
  tail       transform, quantize (RDOQ, where it is on), reconstruct
  stores     recon, publish, levels and modes

The kernel it measures is the package's, with the stamps added; the
stamps cost a few cycles each.  A change to wavefront.cu or
mode_sweep.cuh that moves a stage boundary makes this script stop with
the anchor it could not find.  It also measures a tree from before the
sweep took a cost and a filter mask (copy this file into that tree's
`tools/` and run both in turns): it tries the anchors there in their
older spelling, OLD_SPELLING, and that tree has no fixed-mode body.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch.kernels import build  # noqa: E402
from nanohevc_tpu_torch.kernels import wavefront as kwf  # noqa: E402

STAGES = ["wait+top", "left+bar", "decide", "passes", "winner", "predict",
          "tail", "stores"]
OUT = ROOT / "build" / "wavefront_stages"

# The fixed-mode body's one line, which an older tree lacks.
FIXED_BODY = ("        pred = mode == 1 ? dc_value<N>(s_ref) : "
              "planar_pixel<N>(pref, i, j);\n")
# (file, anchor, text put in its place); each anchor must occur once.
EDITS = [
    ("mode_sweep.cuh", "__constant__ int c_tables[kTableInts];\n",
     "__constant__ int c_tables[kTableInts];\n"
     "__shared__ long long s_clk[16];\n"
     "#define STAMP(k) do { if (threadIdx.x == 0) s_clk[k] = clock64(); "
     "} while (0)\n"),
    ("mode_sweep.cuh", "  int best_cost = 0x7fffffff, best_rank = 0;\n",
     "  int best_cost = 0x7fffffff, best_rank = 0;\n  STAMP(3);\n"),
    ("mode_sweep.cuh",
     "  // --- the winner: lexicographic (cost, rank) minimum over groups",
     "  STAMP(4);\n"
     "  // --- the winner: lexicographic (cost, rank) minimum over groups"),
    ("wavefront.cu", '#include "wavefront_sync.cuh"\n',
     '#include "wavefront_sync.cuh"\n'
     "__device__ unsigned long long g_stages[16];\n"
     'extern "C" int nhv_stages(unsigned long long* host) {\n'
     "  cudaError_t err = cudaDeviceSynchronize();\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyFromSymbol(host, g_stages, sizeof(g_stages));\n"
     "  unsigned long long zero[16] = {0};\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyToSymbol(g_stages, zero, sizeof(zero));\n"
     "  return (int)err;\n"
     "}\n"),
    ("wavefront.cu", "  const int rows = batch * nby;\n  for (;;) {\n",
     "  const int rows = batch * nby;\n"
     "  long long acc[9] = {0};\n"
     "  for (;;) {\n"),
    ("wavefront.cu", "    if (row >= rows) break;\n",
     "    if (row >= rows) {\n"
     "      if (t == 0)\n"
     "        for (int k = 0; k < 9; ++k)\n"
     "          atomicAdd(&g_stages[k], (unsigned long long)acc[k]);\n"
     "      break;\n"
     "    }\n"),
    ("wavefront.cu", "      const int x0 = bx * N;\n",
     "      const int x0 = bx * N;\n      STAMP(0);\n"),
    ("wavefront.cu", "      if (t < NN && j == N - 1) {",
     "      STAMP(1);\n      if (t < NN && j == N - 1) {"),
    ("wavefront.cu",
     "      if constexpr (SWEEP) s_sweep.x[i * (N + 1) + j] = x;\n"
     "      __syncthreads();\n",
     "      if constexpr (SWEEP) s_sweep.x[i * (N + 1) + j] = x;\n"
     "      __syncthreads();\n      STAMP(2);\n"),
    ("wavefront.cu",
     "        pred = predict_pixel<N>(s_ref, pref, s_sweep.mref, mode, i, j);\n",
     "        STAMP(5);\n"
     "        pred = predict_pixel<N>(s_ref, pref, s_sweep.mref, mode, i, j);\n"
     "        STAMP(6);\n"),
    ("wavefront.cu", FIXED_BODY,
     FIXED_BODY + "        STAMP(3); STAMP(4); STAMP(5); STAMP(6);\n"),
    ("wavefront.cu", "        mode = use_dc ? 1 : 0;\n",
     "        mode = use_dc ? 1 : 0;\n"
     "        STAMP(3); STAMP(4); STAMP(5); STAMP(6);\n"),
    ("wavefront.cu", "      if (t < NN) {\n        rec[",
     "      STAMP(7);\n      if (t < NN) {\n        rec["),
    ("wavefront.cu", "        if (p == 0) modes[g] = mode;\n      }\n",
     "        if (p == 0) modes[g] = mode;\n      }\n"
     "      STAMP(8);\n"
     "      if (t == 0) {\n"
     "        for (int k = 1; k < 9; ++k) acc[k] += s_clk[k] - s_clk[k - 1];\n"
     "        ++acc[0];\n"
     "      }\n"),
]


# (this tree's spelling, the older tree's) of the names in the anchors
# that changed when the sweep took a cost and a filter mask.
OLD_SPELLING = (("best_rank", "best_mode"), ("(cost, rank)", "(cost, mode)"),
                ("(SWEEP)", "(SEARCH)"),
                ("s_ref, pref, s_sweep.mref", "s_ref, s_sweep.mref"))


def respelled(text: str) -> str:
    for new, old in OLD_SPELLING:
        text = text.replace(new, old)
    return text


def instrumented_sources() -> Path:
    csrc = OUT / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build._CSRC, csrc)
    for name, anchor, text in EDITS:
        path = csrc / name
        src = path.read_text()
        if src.count(anchor) != 1:
            anchor, text = respelled(anchor), respelled(text)
        if anchor == FIXED_BODY and FIXED_BODY not in src:
            continue
        if src.count(anchor) != 1:
            raise SystemExit(f"{name}: anchor not found once: {anchor!r}")
        path.write_text(src.replace(anchor, text))
    return csrc


def main() -> int:
    if not torch.cuda.is_available():
        print("wavefront_stages: needs a CUDA card", file=sys.stderr)
        return 1
    build._CSRC = instrumented_sources()
    build.BUILD_DIR = OUT
    build.SIGNATURES["wavefront"]["nhv_stages"] = [ctypes.c_void_p]
    lib = kwf.cuda_kernels().lib
    buf = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    rng = np.random.default_rng(cs.SEED + 1)
    for batch in (1, 8):
        for body, (mode_set, decision) in cs.WAVEFRONT_BODIES.items():
            for n in (4, 8, 16, 32):
                planes = cs.stacked_planes((cs.H, cs.W), 8, batch, n, dev, rng)
                kw = dict(mode_set=mode_set, decision=decision, use_dst=n == 4)
                kwf.wavefront_encode_planes(planes, 22, n, **kw)
                if lib.nhv_stages(buf):
                    raise SystemExit("nhv_stages failed")
                for _ in range(3):
                    kwf.wavefront_encode_planes(planes, 22, n, **kw)
                if lib.nhv_stages(buf):
                    raise SystemExit("nhv_stages failed")
                blocks = buf[0]
                parts = [buf[k + 1] / blocks for k in range(len(STAGES))]
                print(f"batch {batch} {body} N={n}: {sum(parts):.0f} cycles a "
                      f"block: " + ", ".join(f"{s} {v:.0f}" for s, v in
                                             zip(STAGES, parts))
                      + f" [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
