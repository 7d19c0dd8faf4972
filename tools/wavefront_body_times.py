"""Time the wavefront kernel's two TPU bodies per 1080p luma plane.

    python3 tools/wavefront_body_times.py                  # this tree
    python3 tools/wavefront_body_times.py --pair-by-sweep  # the variant

Times `wavefront_encode_planes` on a seeded 1080p luma plane, 8-bit,
QP 22, at N 4 (DST), 8, 16 and 32, for the DC/planar body by energy
(K4) and the 35-mode SATD search (K3a/K3b): each line is the median of
5 readings, with their min and max, of the device time of one call in a
CUDA graph of 20 calls.  Built for comparing two trees in one call on
one card: copy this file into the other tree's `tools/` and run both in
turns (A, B, B, A).

With --pair-by-sweep it builds a copy of `nanohevc_tpu_torch/csrc/`
into `build/wavefront_body_times/` in which the DC/planar pair by
energy runs through `mode_sweep<..., kCostEnergy, 2>` (as the pair by
SAD or SATD does) instead of K4's body of `dc_planar.cuh`, checks that
copy against the plain loop on each plane, and times the DC/planar
body alone.  Each line carries the card's name and power limit.
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

REPEATS = 5
BODIES = {"dc_planar": ("dc_planar", "energy"), "search": ("all", "satd")}
OUT = ROOT / "build" / "wavefront_body_times"
# The variant's one edit of wavefront.cu: the pair is a sweep under
# every cost.
PAIR_ANCHOR = "BODY == kBodySweep || (BODY == kBodyPair && COST != kCostEnergy);"
PAIR_BY_SWEEP = "BODY == kBodySweep || BODY == kBodyPair;"


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one fn() call: a graph of `iters` calls, replayed
    after a warm-up (the first call builds the kernel's tables)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def pair_by_sweep_sources() -> Path:
    """A copy of csrc/ whose energy pair runs through the sweep."""
    csrc = OUT / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build._CSRC, csrc)
    path = csrc / "wavefront.cu"
    src = path.read_text()
    if src.count(PAIR_ANCHOR) != 1:
        raise SystemExit(f"wavefront.cu: anchor not found once: {PAIR_ANCHOR!r}")
    path.write_text(src.replace(PAIR_ANCHOR, PAIR_BY_SWEEP))
    return csrc


def main() -> int:
    if not torch.cuda.is_available():
        print("wavefront_body_times: needs a CUDA card", file=sys.stderr)
        return 1
    variant = "--pair-by-sweep" in sys.argv[1:]
    bodies = dict(BODIES)
    tag = "this tree"
    if variant:
        build._CSRC = pair_by_sweep_sources()
        build.BUILD_DIR = OUT
        build.GENERATED_DIR = OUT / "include"
        bodies = {"dc_planar by the sweep": BODIES["dc_planar"]}
        tag = "pair by sweep"
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    y = torch.from_numpy(cs.textured(cs.H, cs.W, 8,
                                     np.random.default_rng(cs.SEED + 1)))
    for body, (mode_set, decision) in bodies.items():
        for n in (4, 8, 16, 32):
            plane = cs.pad_to_blocks(y[None], n).to(dev)  # 1088 rows at 16
            kw = dict(mode_set=mode_set, decision=decision, use_dst=n == 4)
            if variant:
                got = kwf.wavefront_encode_planes(plane, 22, n, **kw)
                want = kwf.wavefront_encode_planes_reference(plane, 22, n, **kw)
                if any(not torch.equal(got[k], want[k]) for k in want):
                    raise SystemExit(f"{body} N={n}: != the plain loop")
            ms = sorted(graph_ms(lambda: kwf.wavefront_encode_planes(
                plane, 22, n, **kw)) for _ in range(REPEATS))
            print(f"[{tag}] {body} 1080p luma N={n}{' DST' if n == 4 else ''}: "
                  f"median of {REPEATS} {ms[REPEATS // 2]:.4f} ms (min "
                  f"{ms[0]:.4f}, max {ms[-1]:.4f}) [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
