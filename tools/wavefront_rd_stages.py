"""Where a diagonal's time goes in the RD kernel, by stage, on one card.

    python3 tools/wavefront_rd_stages.py      # from the root of a checkout

Copies `nanohevc_tpu_torch/csrc/` into `build/wavefront_rd_stages/csrc`,
adds clock64() stamps to the copy of `wavefront_rd.cu`
(`kernels/build.py::edited_copy`; thread 0 of every thread block, at
each stage boundary of every diagonal, summed per thread block and added
up on the device at the kernel's end), builds it with the package's own
build code into `build/wavefront_rd_stages/`, and runs the wrapper on a
seeded 1080p luma plane at N 4 (DST), 8, 16 and 32 under both mode sets
and on 7d's two plane batches.  Prints the mean SM cycles a thread
block spends in each stage of a diagonal, as its thread 0 sees it (a
stage ends at the barrier that closes it, so it holds the wait for the
block's slowest thread):

  message    the first slot's top arm, corner and the mode above, polled
             from the message of the block above
  smooth     the smoothed references, DC, the projection arrays
  cands      the candidates (transform, statistics, bins into shared)
  wait       the block's bins added to the frame's counters, the next
             diagonal's pixels issued, the two counters a context needs
             polled until every thread block of the frame has added
  prices     the float64 prices of a context, the cum1 scan
  bits       each candidate's bits and cost
  decide     each slot's argmin
  code       the chosen blocks written (or coded again)
  next       the windows and references of the next diagonal, and the
             message for the block below

Inside `cands`, thread 0's candidate (its first round) by part:
predict (pixels and prediction), transform (row_tail.cuh's tail),
statistics (SSE, last position, level codes, the group's shuffles) and
bins (the warp's counts into its registers).  The kernel it measures is the
package's, with the stamps added.  A
change to wavefront_rd.cu that moves a stage boundary makes this script
stop with the anchor it could not find.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch.kernels import build  # noqa: E402
from nanohevc_tpu_torch.kernels import wavefront_rd as krd  # noqa: E402

STAGES = ["message", "smooth", "cands", "wait", "prices", "bits", "decide",
          "code", "next"]
# thread 0's candidate (round 0), inside `cands`
SUBSTAGES = ["predict", "transform", "statistics", "bins"]
# thread 0 inside `next`
NEXTSTAGES = ["message", "windows", "barrier", "references"]
OUT = ROOT / "build" / "wavefront_rd_stages"
NS = len(STAGES)
NSUB = len(SUBSTAGES)
NNX = len(NEXTSTAGES)
NW = NS + 1 + NSUB + NNX

# (anchor, text put in its place); each anchor must occur once.
EDITS = [
    ('#include "wavefront_sync.cuh"   // global_ns\n',
     '#include "wavefront_sync.cuh"   // global_ns\n'
     f"__device__ unsigned long long g_stages[{NW}];\n"
     'extern "C" int nhv_stages(unsigned long long* host) {\n'
     "  cudaError_t err = cudaDeviceSynchronize();\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyFromSymbol(host, g_stages, sizeof(g_stages));\n"
     f"  unsigned long long zero[{NW}] = {{0}};\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyToSymbol(g_stages, zero, sizeof(zero));\n"
     "  return (int)err;\n"
     "}\n"
     "#define STAMP(k) do { if (t == 0) clk[k] = clock64(); } while (0)\n"
     "#define SUB(k) do { if (t == 0 && r == 0) sub[k] = clock64(); } while (0)\n"
     "#define NXT(k) do { if (t == 0 && d >= 0) nxt[k] = clock64(); } while (0)\n"),
    ("  const int xstride = a.slots * NN;               // s_x's parity stride\n",
     "  const int xstride = a.slots * NN;               // s_x's parity stride\n"
     f"  unsigned long long clk[{NS + 1}] = {{0}}, acc[{NW}] = {{0}};\n"
     f"  unsigned long long sub[{NSUB + 1}] = {{0}}, nxt[{NNX + 1}] = {{0}};\n"),
    ("    const bool send = below && d >= 0;\n",
     "    const bool send = below && d >= 0;\n    NXT(0);\n"),
    ("      st_relaxed(msg_out + u, tag | (unsigned)v);\n    }\n",
     "      st_relaxed(msg_out + u, tag | (unsigned)v);\n    }\n    NXT(1);\n"),
    ("    __syncthreads();\n    // the references of d + 1: the edge rules;",
     "    NXT(2);\n    __syncthreads();\n    NXT(3);\n"
     "    // the references of d + 1: the edge rules;"),
    ("      if (!from_msg) s_ref[k] = v;\n    }\n",
     "      if (!from_msg) s_ref[k] = v;\n    }\n    NXT(4);\n"),
    ("    const int* xs = s_x + (d & 1) * xstride;\n",
     "    const int* xs = s_x + (d & 1) * xstride;\n    STAMP(0);\n"),
    ("        s_misc[0] = 1;                    // DC\n      }\n      __syncthreads();\n",
     "        s_misc[0] = 1;                    // DC\n      }\n      __syncthreads();\n"
     "      STAMP(1);\n"),
    ("    // the candidates, in rounds of GA groups\n",
     "    STAMP(2);\n    // the candidates, in rounds of GA groups\n"),
    ("      const int4* xr = reinterpret_cast<const int4*>(xs + wi * NN + i * N);\n",
     "      SUB(0);\n"
     "      const int4* xr = reinterpret_cast<const int4*>(xs + wi * NN + i * N);\n"),
    ("        }\n#pragma unroll\n        for (int j = 0; j < N; ++j) res[j] = x[j] - pred[j];\n",
     "        }\n        SUB(1);\n#pragma unroll\n"
     "        for (int j = 0; j < N; ++j) res[j] = x[j] - pred[j];\n"),
    ("                                             a.q, lev, rec);\n",
     "                                             a.q, lev, rec);\n      SUB(2);\n"),
    ("      st.sig_gt1 = pk;\n", "      st.sig_gt1 = pk;\n      SUB(3);\n"),
    ("                                bins);\n      }\n",
     "                                bins);\n        SUB(4);\n      }\n"),
    ("    // this block's bins of d: (count << 32) | 1 added to every counter of\n",
     "    STAMP(3);\n"
     "    // this block's bins of d: (count << 32) | 1 added to every counter of\n"),
    ("        const int n0 = poll_count(cb + i0, v0, a.groups);\n",
     "        const int n0 = poll_count(cb + i0, v0, a.groups);\n"
     "        STAMP(4);\n"),
    ("    // each candidate's cost; with one candidate a group (keep), the pair\n",
     "    STAMP(5);\n"
     "    // each candidate's cost; with one candidate a group (keep), the pair\n"),
    ("    // the decision of each slot (but the pair's by shuffle)\n",
     "    STAMP(6);\n    // the decision of each slot (but the pair's by shuffle)\n"),
    ("    // code the chosen blocks: each slot's bottom row and right column for\n",
     "    STAMP(7);\n"
     "    // code the chosen blocks: each slot's bottom row and right column for\n"),
    ("      next_refs(d);\n    }\n",
     "      STAMP(8);\n"
     "      next_refs(d);\n"
     f"      STAMP({NS});\n"
     "      if (t == 0) {\n"
     f"        for (int k = 1; k <= {NS}; ++k) acc[k] += clk[k] - clk[k - 1];\n"
     f"        for (int k = 1; k <= {NSUB}; ++k) acc[{NS} + k] += sub[k] - sub[k - 1];\n"
     f"        for (int k = 1; k <= {NNX}; ++k) acc[{NS + NSUB} + k] += nxt[k] - nxt[k - 1];\n"
     "        ++acc[0];\n"
     "      }\n"
     "    }\n"),
    ("  }\n}\n\n// The encoder's synchronisation alone",
     "  }\n"
     "  if (t == 0)\n"
     f"    for (int k = 0; k < {NW}; ++k) atomicAdd(&g_stages[k], acc[k]);\n"
     "}\n\n// The encoder's synchronisation alone"),
]


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("wavefront_rd_stages: needs a CUDA card", file=sys.stderr)
        return 1
    build._CSRC = build.edited_copy(
        OUT, [("wavefront_rd.cu", anchor, text) for anchor, text in EDITS])
    build.BUILD_DIR = OUT
    build.SIGNATURES["wavefront_rd"]["nhv_stages"] = [ctypes.c_void_p]
    lib = krd.cuda_kernels().lib
    buf = (ctypes.c_ulonglong * NW)()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    rng = np.random.default_rng(cs.SEED + 1)
    runs = []
    for n, dst in ((4, True), (8, False), (16, False), (32, False)):
        y = cs.stacked_planes((cs.H, cs.W), 8, 1, n, dev, rng)
        for mode_set in cs.RD_SETS:
            runs.append((f"1080p luma N={n}{' DST' if dst else ''} "
                         f"{mode_set}", y, n,
                         dict(mode_set=mode_set, use_dst=dst)))
    runs += cs.rd_batches(dev, rng)
    for label, planes, n, kw in runs:
        krd.wavefront_rd_encode_planes(planes, 22, n, **kw)
        if lib.nhv_stages(buf):
            raise SystemExit("nhv_stages failed")
        for _ in range(3):
            krd.wavefront_rd_encode_planes(planes, 22, n, **kw)
        if lib.nhv_stages(buf):
            raise SystemExit("nhv_stages failed")
        steps = buf[0]
        parts = [buf[k + 1] / steps for k in range(NS)]
        subs = [buf[NS + 1 + k] / steps for k in range(NSUB)]
        nxts = [buf[NS + NSUB + 1 + k] / steps for k in range(NNX)]
        print(f"{label}: {sum(parts):.0f} cycles a diagonal: "
              + ", ".join(f"{s} {v:.0f}" for s, v in zip(STAGES, parts))
              + " (of cands, thread 0's candidate: "
              + ", ".join(f"{s} {v:.0f}" for s, v in zip(SUBSTAGES, subs))
              + "; of next: "
              + ", ".join(f"{s} {v:.0f}" for s, v in zip(NEXTSTAGES, nxts))
              + f") [{gpu}]", flush=True)
    print(f"SM clock after the runs, now / max: {sm_clock()} [{gpu}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
