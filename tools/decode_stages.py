"""Where a block's time goes in the decode kernel, by stage, on one card.

    python3 tools/decode_stages.py      # from the root of a checkout

Copies `nanohevc_tpu_torch/csrc/` into `build/decode_stages/csrc`, adds
clock64() stamps to the copy of `decode.cu` (`kernels/build.py::
edited_copy`; the first thread of each
block row's team, at each stage boundary of every block, summed per
team and added up on the device at the kernel's end), builds it with the
package's own build code into `build/decode_stages/`, and runs the
wrapper on the closed loop's 1080p luma planes (the search stream at N
4 DST, 8, 16, 32, a batch of 8 of them at N=8, and the default stream
at N=8).  Prints the mean SM cycles a block spends in each stage, as
that thread sees it, and the SM clock after the runs:

  mode       the block's mode (a shuffle), the next block's residual
             loads issued
  indices    an angular mode's reference indices and weights, read from
             the thread block's table (N <= 16)
  top wait   the top arm's words polled (shared line or edge buffer)
  refs       the references written, the team's barrier
  smooth     the corner's shuffle, the smoothing and (N = 32) the
             projection array, where the mode takes them
  pixels     prediction, residual, clip, publish, recon and left-arm
             stores, the bottom row first; the next block's residual
             moved into place

The kernel it measures is the package's, with the stamps added; the
stamps cost a few cycles each.  A change to decode.cu that moves a
stage boundary makes this script stop with the anchor it could not find.
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
from nanohevc_tpu_torch.kernels import decode as kd  # noqa: E402

STAGES = ["mode", "indices", "top wait", "refs", "smooth", "pixels"]
OUT = ROOT / "build" / "decode_stages"

# (anchor, text put in its place); each anchor must occur once in decode.cu.
EDITS = [
    ('#include "mode_sweep.cuh"   // c_tables and the predictors\n',
     '#include "mode_sweep.cuh"   // c_tables and the predictors\n'
     "__device__ unsigned long long g_stages[8];\n"
     'extern "C" int nhv_stages(unsigned long long* host) {\n'
     "  cudaError_t err = cudaDeviceSynchronize();\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyFromSymbol(host, g_stages, sizeof(g_stages));\n"
     "  unsigned long long zero[8] = {0};\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyToSymbol(g_stages, zero, sizeof(zero));\n"
     "  return (int)err;\n"
     "}\n"
     "#define STAMP(k) do { if (t == 0) clk[k] = clock64(); } while (0)\n"),
    ("  const int bar_id = 1 + w;\n",
     "  const int bar_id = 1 + w;\n"
     "  long long clk[7] = {0}, acc[7] = {0};\n"),
    ("    if (grp >= batch * groups) break;\n",
     "    if (grp >= batch * groups) {\n"
     "      if (t == 0)\n"
     "        for (int k = 0; k < 7; ++k)\n"
     "          atomicAdd(&g_stages[k], (unsigned long long)acc[k]);\n"
     "      break;\n"
     "    }\n"),
    ("        const int x0 = bx * N;\n",
     "        const int x0 = bx * N;\n        STAMP(0);\n"),
    ("        // --- an angular mode's reference indices",
     "        STAMP(1);\n        // --- an angular mode's reference indices"),
    ("        // --- references (availability rule)",
     "        STAMP(2);\n        // --- references (availability rule)"),
    ("                          : poll_line(line_above + x0 + t, tag);\n",
     "                          : poll_line(line_above + x0 + t, tag);\n"
     "          STAMP(3);\n"),
    ("        team_sync<TEAM>(bar_id);\n        if (t < 32) corner",
     "        team_sync<TEAM>(bar_id);\n        STAMP(4);\n"
     "        if (t < 32) corner"),
    ("        // --- prediction, residual, clip",
     "        STAMP(5);\n        // --- prediction, residual, clip"),
    ("        for (int k = 0; k < P; ++k) cur[k] = nxt[k];\n",
     "        for (int k = 0; k < P; ++k) cur[k] = nxt[k];\n"
     "        STAMP(6);\n"
     "        if (t == 0) {\n"
     "          for (int k = 1; k < 7; ++k) acc[k] += clk[k] - clk[k - 1];\n"
     "          ++acc[0];\n"
     "        }\n"),
]


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_stages: needs a CUDA card", file=sys.stderr)
        return 1
    build._CSRC = build.edited_copy(
        OUT, [("decode.cu", anchor, text) for anchor, text in EDITS])
    build.BUILD_DIR = OUT
    build.SIGNATURES["decode"]["nhv_stages"] = [ctypes.c_void_p]
    lib = kd.cuda_kernels().lib
    buf = (ctypes.c_ulonglong * 8)()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    y = torch.from_numpy(frame.y.data.astype(np.int32))[None].to(dev)
    runs = []
    for label, mode_set, decision in (("search", "all", "satd"),
                                      ("default", "dc_planar", "energy")):
        for n, dst in cs.DECODE_SIZES:
            if label == "default" and n != 8:
                continue
            out = cs.encode_planes_closed_loop(y, 22, n=n, mode_set=mode_set,
                                               decision=decision, use_dst=dst)
            hp, wp = -(-cs.H // n) * n, -(-cs.W // n) * n
            md = out["modes"].contiguous()
            res = cs.decode_residual(out["levels"], md, [22], n=n, hp=hp,
                                     wp=wp, use_dst=dst)
            runs.append((f"{label} N={n}{' DST' if dst else ''}", res, md, n))
            if label == "search" and n == 8:
                runs.append((f"search N=8 x {cs.DECODE_CHUNK}",
                             res.expand(cs.DECODE_CHUNK, -1, -1).contiguous(),
                             md.expand(cs.DECODE_CHUNK, -1).contiguous(), n))
    for label, res, md, n in runs:
        kd.decode_blocks(res, md, n)
        if lib.nhv_stages(buf):
            raise SystemExit("nhv_stages failed")
        for _ in range(3):
            kd.decode_blocks(res, md, n)
        if lib.nhv_stages(buf):
            raise SystemExit("nhv_stages failed")
        blocks = buf[0]
        parts = [buf[k + 1] / blocks for k in range(len(STAGES))]
        print(f"{label}, 1080p luma: {sum(parts):.0f} cycles a block: "
              + ", ".join(f"{s} {v:.0f}" for s, v in zip(STAGES, parts))
              + f" [{gpu}]", flush=True)
    print(f"SM clock after the runs, now / max: {sm_clock()} [{gpu}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
