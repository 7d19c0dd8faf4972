"""Where a block's time goes in the wavefront kernel, by stage, on one card.

    python3 tools/wavefront_stages.py      # from the root of a checkout
    python3 tools/wavefront_stages.py --tree build/parent   # another tree

Copies `nanohevc_tpu_torch/csrc/` (or TREE's) into
`build/wavefront_stages/csrc`, adds clock64() stamps to the copy
(thread 0 of each thread block, at each stage boundary of every block,
summed per thread block and added up on the device at its end), builds
it with the package's own build code into `build/wavefront_stages/`,
and runs the wrapper on seeded 1080p luma planes: batch 1 and 8, both
TPU bodies, N 4-32; then the DC/planar body under RDOQ (diagonal scan)
at N 4 (DST), 8, 16 and 32, and the search under RDOQ at N=8.  Prints
the mean SM cycles a block spends in each stage, as thread 0 sees it:

  wait+top     the top arm: waiting for the row above and reading it
  left+bar     the left arm from registers, and the barrier before the body
  decide       the DC/planar decision (DC/planar body); the DC value
               (search body); the smoothing, where it is on
  passes       the search's passes over the modes
  winner       the search's (cost, mode) minimum across groups and warps
  predict      the winner's prediction, per pixel
  fwd+quant    the forward transform and the deadzone quantizer
  rdoq loads   RDOQ: the thread's scan position, gain and rate-table
               entries (0 where the tail keeps them in registers)
  stage A      RDOQ: the last significant position and the level trim
  sums         RDOQ: the runs, carries and total in XLA's order
  first min    RDOQ: the cost of each last position and the first minimum
  deq+inv      dequantize, inverse transform, clip
  stores       the hand-off to the row below, recon, levels and modes

The RDOQ stages read 0 without RDOQ.  The kernel it measures is the
package's (or TREE's), with the stamps added; the stamps cost a few
cycles each.  A change that moves a stage boundary makes this script
stop with the anchor it could not find.  `--tree` measures a tree
whose kernel still waits on a per-row flag (PARENT_SPELLING gives
those anchors), launched through that tree's C interface where it
predates the grid cap (tools/torch_wavefront_phase.py, ParentAbi).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch.kernels import build  # noqa: E402
from nanohevc_tpu_torch.kernels import wavefront as kwf  # noqa: E402
from tools.torch_wavefront_phase import parent_library  # noqa: E402

STAGES = ["wait+top", "left+bar", "decide", "passes", "winner", "predict",
          "fwd+quant", "rdoq loads", "stage A", "sums", "first min",
          "deq+inv", "stores"]
K = len(STAGES) + 1                     # stamps a block
OUT = ROOT / "build" / "wavefront_stages"

# The fixed-mode body's one line.
FIXED_BODY = ("        pred = mode == 1 ? dc_value<N>(s_ref) : "
              "planar_pixel<N>(pref, i, j);\n")
# (file, anchor, text put in its place); each anchor must occur once.
EDITS = [
    ("encode_tail.cuh", "#include <cuda_runtime.h>\n",
     "#include <cuda_runtime.h>\n"
     "__shared__ long long s_clk[16];\n"
     "__shared__ int s_dep;\n"
     "#define STAMP(k) do { if (threadIdx.x == 0) s_clk[k] = clock64(); "
     "} while (0)\n"
     "// a stamp taken once v is ready (its store waits for it)\n"
     "#define STAMP_DEP(k, v) do { if (threadIdx.x == 0) { s_dep = (v); "
     "s_clk[k] = clock64(); } } while (0)\n"),
    ("encode_tail.cuh",
     "  level = adjust(coeff, coeff > 0 ? mag : (coeff < 0 ? -mag : 0));\n",
     "  STAMP_DEP(6, mag);\n"
     "  STAMP(7); STAMP(8); STAMP(9); STAMP(10);\n"
     "  level = adjust(coeff, coeff > 0 ? mag : (coeff < 0 ? -mag : 0));\n"),
    ("mode_sweep.cuh", "  int best_cost = 0x7fffffff, best_rank = 0;\n",
     "  int best_cost = 0x7fffffff, best_rank = 0;\n  STAMP(2);\n"),
    ("mode_sweep.cuh",
     "  // --- the winner: lexicographic (cost, rank) minimum over groups",
     "  STAMP(3);\n"
     "  // --- the winner: lexicographic (cost, rank) minimum over groups"),
    ("rdoq_tail.cuh", "  const int a = level < 0 ? -level : level;\n",
     "  STAMP_DEP(7, k ^ __float_as_int(g) ^ __float_as_int(sig0) ^ "
     "__float_as_int(sig1) ^ __float_as_int(last_bits));\n"
     "  const int a = level < 0 ? -level : level;\n"),
    ("rdoq_tail.cuh", "  // --- stage B: the sums in XLA's order",
     "  STAMP(8);\n  // --- stage B: the sums in XLA's order"),
    ("rdoq_tail.cuh", "  const int run = k >> 4;\n",
     "  STAMP(9);\n  const int run = k >> 4;\n"),
    ("rdoq_tail.cuh", "  return k <= best_k && !all_zero ? sgn * kept : 0;\n",
     "  STAMP(10);\n"
     "  return k <= best_k && !all_zero ? sgn * kept : 0;\n"),
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
    ("wavefront.cu", "  const int rows = batch * nby;\n",
     "  const int rows = batch * nby;\n"
     f"  long long acc[{K}] = {{0}};\n"),
    ("wavefront.cu", "    if (row >= rows) break;\n",
     "    if (row >= rows) {\n"
     "      if (t == 0)\n"
     f"        for (int k = 0; k < {K}; ++k)\n"
     "          atomicAdd(&g_stages[k], (unsigned long long)acc[k]);\n"
     "      break;\n"
     "    }\n"),
    ("wavefront.cu", "      const int x0 = bx * N;\n",
     "      const int x0 = bx * N;\n      STAMP(13);\n"),
    ("wavefront.cu", "      if (t < NN && j == N - 1) {",
     "      STAMP(0);\n      if (t < NN && j == N - 1) {"),
    ("wavefront.cu",
     "      if constexpr (SWEEP) s_sweep.x[i * (N + 1) + j] = x;\n"
     "      __syncthreads();\n",
     "      if constexpr (SWEEP) s_sweep.x[i * (N + 1) + j] = x;\n"
     "      __syncthreads();\n      STAMP(1);\n"),
    ("wavefront.cu",
     "        pred = predict_pixel<N>(s_ref, pref, s_sweep.mref, mode, i, j);\n",
     "        STAMP(4);\n"
     "        pred = predict_pixel<N>(s_ref, pref, s_sweep.mref, mode, i, j);\n"
     "        STAMP_DEP(5, pred);\n"),
    ("wavefront.cu", FIXED_BODY,
     FIXED_BODY + "        STAMP(2); STAMP(3); STAMP(4); "
     "STAMP_DEP(5, pred);\n"),
    ("wavefront.cu", "        mode = use_dc ? 1 : 0;\n",
     "        mode = use_dc ? 1 : 0;\n"
     "        STAMP(2); STAMP(3); STAMP(4); STAMP_DEP(5, pred);\n"),
    ("wavefront.cu", "      // --- the hand-off, then the outputs",
     "      STAMP_DEP(11, r);\n      // --- the hand-off, then the outputs"),
    ("wavefront.cu", "        if (p == 0) modes[g] = mode;\n      }\n",
     "        if (p == 0) modes[g] = mode;\n      }\n"
     "      STAMP(12);\n"
     "      if (t == 0) {\n"
     "        long long prev = s_clk[13];\n"
     f"        for (int k = 0; k < {K - 1}; ++k) {{\n"
     "          acc[k + 1] += s_clk[k] - prev;\n"
     "          prev = s_clk[k];\n"
     "        }\n"
     "        ++acc[0];\n"
     "      }\n"),
]

# (this tree's spelling, the parent's) of the anchors that moved when the
# hand-off became self-announcing words.
PARENT_SPELLING = (
    ("      // --- the hand-off, then the outputs",
     "      if (t < NN) {\n        rec["),
)


def parent_spelled(text: str) -> str:
    for new, old in PARENT_SPELLING:
        text = text.replace(new, old)
    return text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path,
                    help="measure this tree's kernel (the parent's, from "
                         "before the word hand-off) instead of this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wavefront_stages: needs a CUDA card", file=sys.stderr)
        return 1
    tree_csrc = None if args.tree is None else (
        args.tree / "nanohevc_tpu_torch" / "csrc")
    csrc = build.edited_copy(OUT, EDITS, tree_csrc, respell=parent_spelled)
    kern = parent_library(csrc, OUT, {"nhv_stages": [ctypes.c_void_p]})
    lib = kern.lib
    buf = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    what = f"tree {args.tree}" if args.tree else "this tree"
    print(f"{gpu}; {what}", flush=True)
    rng = np.random.default_rng(cs.SEED + 1)
    cases = [(batch, body, n, dict(mode_set=ms, decision=dec))
             for batch in (1, 8)
             for body, (ms, dec) in cs.WAVEFRONT_BODIES.items()
             for n in (4, 8, 16, 32)]
    cases += [(1, "dc_planar+rdoq", n, dict(mode_set="dc_planar",
                                            decision="energy", rdoq=True))
              for n in (4, 8, 16, 32)]
    cases.append((1, "search+rdoq", 8, dict(mode_set="all", decision="satd",
                                            rdoq=True)))
    for batch, body, n, kw in cases:
        planes = cs.stacked_planes((cs.H, cs.W), 8, batch, n, dev, rng)
        kw = dict(kw, use_dst=n == 4)
        kwf._launch(kern, planes, 22, n, **kw)
        if lib.nhv_stages(buf):
            raise SystemExit("nhv_stages failed")
        for _ in range(3):
            kwf._launch(kern, planes, 22, n, **kw)
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
