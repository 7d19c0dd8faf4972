"""Time the port's CUDA kernels per seeded 1080p luma plane on one card.

    python3 tools/torch_kernel_times.py      # from the root of a checkout

Runs the timing phases of `chip_smoke.py` and nothing else: K1 and K2
(phases 6, 6b), the wavefront kernel with both bodies, its grids per
call and its batches (6c), and K5 per plane at N 4-32 (as 6e).  Each
line carries the card's name and power limit.  Built for comparing two
trees in one call on one card: copy this file into the other tree's
`tools/` and run both in turns (A, B, B, A).
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    cs.kernel_times(dev, "slab_encode_plane", "6", gpu)
    cs.kernel_times(dev, "mode_search_encode_plane", "6b", gpu)
    cs.wavefront_times(dev, gpu)
    y = torch.from_numpy(cs.textured(cs.H, cs.W, 8,
                                     np.random.default_rng(cs.SEED + 1))).to(dev)
    for n in (4, 8, 16, 32):
        blocks = ops.tile_plane(y, n).contiguous()
        refs = ops.extract_refs(y, n)
        k_ms = cs.cuda_ms(lambda: fused_encode_blocks(blocks, refs, 22))
        print(f"[6e] fused_encode_blocks 1080p luma N={n}: kernel {k_ms:.4f} "
              f"ms [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
