"""Run the RD closed loop's kernel phases of `chip_smoke.py` alone.

    python3 tools/torch_wavefront_rd_phase.py           # 3h, price sweep
    python3 tools/torch_wavefront_rd_phase.py --times   # and 6h

Builds the kernels (printing the RD library's registers and spills),
then runs `chip_smoke`'s 3h (the kernel == `_encode_planes_rd` on the
card over the crops' cases, the 1080p luma plane at N=8 under both
mode sets and the sequence's RD batches, three repeats each) and its
price sweep (the device prices
== the host's `_prices`, 0 bits differing).  With --times, 6h: the
kernel per 1080p luma plane at every N beside its empty-body barrier
kernel, its bound and the plain loop.  Each timing line carries the
card's name and power limit; exits non-zero when there is no card or a
check fails.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wavefront_rd_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    for stem, info in cs.build.build_libraries().items():
        cs.log(f"{stem} library built in {info.seconds:.2f} s"
               f"{' (cached)' if info.cached else ''}")
        if stem == "wavefront_rd":
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line:
                    cs.log(f"  {line.strip()}")
    cs.phase_wavefront_rd_vs_plain(dev)
    cs.phase_rd_prices(dev, gpu)
    if "--times" in sys.argv[1:]:
        cs.rd_times(dev, gpu)
    cs.log(f"torch_wavefront_rd_phase: passed in "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
