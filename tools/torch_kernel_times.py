"""Time the port's CUDA kernels per seeded 1080p luma plane on one card.

    python3 tools/torch_kernel_times.py      # from the root of a checkout

Runs the timing phases of `chip_smoke.py` and nothing else: K1 and K5
per plane at N 4-32 (DST at 4 for K1), and K5 on a batch of 8 planes
at N=8, each as the median of 5 repeats with their min and max, twice:
`chip_smoke.cuda_ms` (a loop of 50 launches, which reads the wrapper's
host cost where that exceeds the kernel's) and the device time of a
CUDA graph of 20 calls; the cold-L2 device time of both at N=8; then
K2 (phase 6b), and the wavefront kernel with both bodies, its grids per
call and its batches (6c).  Each line carries the card's name and power
limit.  Built for comparing two trees in one call on one card: copy
this file into the other tree's `tools/` and run both in turns (A, B,
B, A).  It keeps its own graph timers, since an older tree's
`chip_smoke.py` has none.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nanohevc_tpu_torch import ops  # noqa: E402
from nanohevc_tpu_torch.kernels.fused_pipeline import fused_encode_blocks  # noqa: E402
from nanohevc_tpu_torch.kernels.slab_pipeline import slab_encode_plane  # noqa: E402

REPEATS = 5


def captured(fn, iters: int):
    """A CUDA graph of `iters` fn() calls, captured after a warm-up."""
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
    return graph


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one fn() call: a graph of `iters` calls, replayed."""
    graph = captured(fn, iters)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_graph_ms(fn, dev, iters: int = 10) -> float:
    """Device time of one fn() call with the L2 overwritten before it."""
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    graph = captured(fn, 1)
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def spread(fn) -> str:
    """Median, min and max of REPEATS readings of cuda_ms and graph_ms."""
    out = []
    for label, timer in (("launch loop", cs.cuda_ms), ("device", graph_ms)):
        ms = sorted(timer(fn) for _ in range(REPEATS))
        out.append(f"{label} median of {REPEATS} {ms[REPEATS // 2]:.4f} ms "
                   f"(min {ms[0]:.4f}, max {ms[-1]:.4f})")
    return "; ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    y = torch.from_numpy(cs.textured(cs.H, cs.W, 8,
                                     np.random.default_rng(cs.SEED + 1))).to(dev)
    for n in (4, 8, 16, 32):
        dst = n == 4
        print(f"[6] slab_encode_plane 1080p luma N={n}{' DST' if dst else ''}: "
              f"{spread(lambda: slab_encode_plane(y, 22, n, use_dst=dst))} "
              f"[{gpu}]", flush=True)
    cold = cold_graph_ms(lambda: slab_encode_plane(y, 22, 8), dev)
    print(f"[6] slab_encode_plane 1080p luma N=8 with L2 flushed before each "
          f"launch (device): {cold:.4f} ms [{gpu}]", flush=True)
    for n in (4, 8, 16, 32):
        blocks = ops.tile_plane(y, n).contiguous()
        refs = ops.extract_refs(y, n)
        print(f"[6e] fused_encode_blocks 1080p luma N={n}: "
              f"{spread(lambda: fused_encode_blocks(blocks, refs, 22))} "
              f"[{gpu}]", flush=True)
        if n == 8:
            cold = cold_graph_ms(
                lambda: fused_encode_blocks(blocks, refs, 22), dev)
            print(f"[6e] fused_encode_blocks 1080p luma N=8 with L2 flushed "
                  f"before each launch (device): {cold:.4f} ms [{gpu}]",
                  flush=True)
    rng = np.random.default_rng(cs.SEED + 2)
    planes8 = torch.from_numpy(np.stack(
        [cs.textured(cs.H, cs.W, 8, rng) for _ in range(8)])).to(dev)
    blocks8 = torch.stack([ops.tile_plane(p, 8) for p in planes8]).reshape(-1, 8, 8)
    refs8 = torch.stack([ops.extract_refs(p, 8) for p in planes8]).reshape(-1, 34)
    print(f"[6e] fused_encode_blocks batch of 8 1080p luma planes N=8: "
          f"{spread(lambda: fused_encode_blocks(blocks8, refs8, 22))} [{gpu}]",
          flush=True)
    cs.kernel_times(dev, "mode_search_encode_plane", "6b", gpu)
    cs.wavefront_times(dev, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
