"""Time the decode kernel against variants of its design, on one card.

    python3 tools/decode_variants.py      # from the root of a checkout

Builds `nanohevc_tpu_torch/csrc/decode.cu` as it is and in variants that
each change one choice of its design, by editing the one line that makes
the choice in a copy under `build/decode_variants/`
(`kernels/build.py::edited_copy`, `build_copy`):

  one warp     one warp a block row at every N (team_warps)
  two warps    two warps a block row at N 8, 16 and 32
  warpgroup    four warps a block row at N = 8 as at 16 and 32
  no table     every N builds the projection array (no index table)
  table at 32  the index table at N = 32 too (135 KB of shared memory)

Then, on the closed loop's 1080p search stream's luma plane at N 4
(DST), 8, 16, 32 and on a batch of 8 such planes at N=8, each at the
W its own library chooses, checks that every variant gives the kernel's pixels and
times them in turns (the kernel, the variants, then the same in reverse
order) through a CUDA graph.  Each line carries the card's name and
power limit.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import torch_decode_phase as tdp  # noqa: E402
from nanohevc_tpu_torch.kernels import build  # noqa: E402
from nanohevc_tpu_torch.kernels import decode as kd  # noqa: E402

OUT = ROOT / "build" / "decode_variants"
TEAM = "  return N >= 16 ? 4 : N == 8 ? 2 : 1;\n"
INDEXED = "  return N <= 16;\n"
# name -> [(anchor, text put in its place)] in decode.cu
VARIANTS = {
    "kernel": [],
    "one warp": [(TEAM, "  return 1;\n")],
    "two warps": [(TEAM, "  return N >= 8 ? 2 : 1;\n")],
    "warpgroup": [(TEAM, "  return N >= 8 ? 4 : 1;\n")],
    "no table": [(INDEXED, "  return false;\n")],
    "table at 32": [(INDEXED, "  return true;\n")],
}


def build_variant(name: str, edits: list):
    """nvcc of an edited copy of decode.cu; the loaded library, its
    table uploaded to card 0."""
    out = OUT / name.replace(" ", "_")
    csrc = build.edited_copy(out, [("decode.cu", a, t) for a, t in edits])
    kern = build.KernelLibrary("decode", kd.cuda_kernels().table,
                               build.build_copy(csrc, "decode", out))
    kern.ensure_tables(0)
    return kern.lib


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_variants: needs a CUDA card", file=sys.stderr)
        return 1
    shutil.rmtree(OUT, ignore_errors=True)
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    libs = {name: build_variant(name, edits)
            for name, edits in VARIANTS.items()}
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    planes = tdp.search_planes(dev, frame, batch=cs.DECODE_CHUNK)
    names = list(VARIANTS)
    for key, (res, md, n, dst) in planes.items():
        want = kd.decode_blocks(res, md, n)
        calls = {name: (lambda lib=lib: kd._launch(lib, res, md, n)[0])
                 for name, lib in libs.items()}
        for name, fn in calls.items():
            if not torch.equal(fn(), want):
                raise SystemExit(f"{name} at {key}: pixels differ from the "
                                 "kernel's")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(cs.graph_ms(calls[name]))
        label = key if res.shape[0] > 1 else f"N={n}{' DST' if dst else ''}"
        print(f"{label}, 1080p luma, W={kd.group_rows(n, *res.shape[1:], 0)}"
              " (the kernel's), "
              "ms (CUDA graph, in turns): "
              + ", ".join(f"{name} {a:.4f} / {b:.4f}"
                          for name, (a, b) in times.items())
              + f" [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
