"""Time the wavefront kernel against variants of its hand-off, on one card.

    python3 tools/wavefront_variants.py      # from the root of a checkout

Builds `nanohevc_tpu_torch/csrc/wavefront.cu` as it is and in variants
that each change one choice of its row hand-off, by editing a copy under
`build/wavefront_variants/` (`kernels/build.py::edited_copy`,
`build_copy`):

  prefetch never   no body loads block bx + 1's words while block bx
                   computes (the kernel: the 35-mode sweep without RDOQ
                   does)
  prefetch always  every body does
  tight 1024       1024 polls back to back before the backoff (32 in
                   the kernel)
  no sleep         the polls never back off with __nanosleep

Then, on seeded 1080p luma planes (DC/planar + RDOQ and the search +
RDOQ at N=8, K4's and K3's bodies at N=8) and on 7d's RDOQ luma batch (8
1080p planes, N=8), checks that every variant gives the kernel's recon,
levels and modes and times them in turns (the kernel, the variants,
then the same in reverse order) through a CUDA graph.  Each line
carries the card's name and power limit.
"""

from __future__ import annotations

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
from tools.torch_wavefront_phase import parent_library  # noqa: E402

OUT = ROOT / "build" / "wavefront_variants"
PREFETCH = "  constexpr bool PREFETCH = BODY == kBodySweep && !RDOQ;\n"
# name -> [(file, anchor, text put in its place)]
VARIANTS = {
    "kernel": [],
    "prefetch never": [
        ("wavefront.cu", PREFETCH, "  constexpr bool PREFETCH = false;\n")],
    "prefetch always": [
        ("wavefront.cu", PREFETCH, "  constexpr bool PREFETCH = true;\n")],
    "tight 1024": [("wavefront_sync.cuh", "    if (++spins < 32) continue;\n",
                    "    if (++spins < 1024) continue;\n")],
    "no sleep": [("wavefront_sync.cuh", "    __nanosleep(ns);\n", "")],
}


def cases(dev) -> list:
    rng = np.random.default_rng(cs.SEED + 1)
    y = cs.stacked_planes((cs.H, cs.W), 8, 1, 8, dev, rng)
    out = [(f"1080p luma N=8 {label}", y, kw) for label, kw in (
        ("DC/planar + RDOQ", dict(mode_set="dc_planar", rdoq=True)),
        ("search + RDOQ", dict(mode_set="all", decision="satd", rdoq=True)),
        ("K4 DC/planar", dict(mode_set="dc_planar")),
        ("K3 search", dict(mode_set="all", decision="satd")))]
    out.append(("7d's RDOQ luma batch, 8 1080p planes N=8",
                cs.stacked_planes((cs.H, cs.W), 8, cs.SEQ_BATCH, 8, dev, rng),
                dict(mode_set="dc_planar", rdoq=True)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wavefront_variants: needs a CUDA card", file=sys.stderr)
        return 1
    shutil.rmtree(OUT, ignore_errors=True)
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    libs = {}
    for name, edits in VARIANTS.items():
        out = OUT / name.replace(" ", "_")
        libs[name] = parent_library(build.edited_copy(out, edits), out)
    names = list(VARIANTS)
    for label, planes, kw in cases(dev):
        calls = {name: (lambda kern=kern: kwf._launch(kern, planes, 22, 8,
                                                      **kw)[0])
                 for name, kern in libs.items()}
        want = calls["kernel"]()
        for name, fn in calls.items():
            if cs.max_abs_err(fn(), want):
                raise SystemExit(f"{name} at {label}: outputs differ from "
                                 "the kernel's")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(cs.graph_ms(calls[name], iters=3, replays=3))
        print(f"{label}, ms (CUDA graph, in turns): "
              + ", ".join(f"{name} {a:.4f} / {b:.4f}"
                          for name, (a, b) in times.items())
              + f"; outputs equal [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
