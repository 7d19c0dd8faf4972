"""Run the wavefront kernel's phases of `chip_smoke.py` alone.

    python3 tools/torch_wavefront_phase.py           # checks only
    python3 tools/torch_wavefront_phase.py --times   # and 6c, 6g

Builds the kernels (printing the wavefront, mode-search and decode
libraries' registers and spills), then runs `chip_smoke`'s checks of the
kernels that share the wavefront kernel's headers: 3b (the mode-search
kernel == its plain version), 3c (the wavefront kernel's two TPU bodies
== the plain loop), 3g (every body and switch of JAX's closed-loop XLA
scan == the plain loop, then at full size three times: two 1080p luma
planes and the sequence's luma and chroma batches under RDOQ) and
3f (the decode kernel == its plain version, on the seeded 1080p frame's
mode-search stream).  With --times, 6c and 6g: the kernel's times per
1080p luma plane.  Each timing line carries the card's name and power
limit; exits non-zero when there is no card or a check fails.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wavefront_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    for stem, info in cs.build.build_libraries().items():
        cs.log(f"{stem} library built in {info.seconds:.2f} s"
               f"{' (cached)' if info.cached else ''}")
        if stem in ("wavefront", "mode_search", "decode"):
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line:
                    cs.log(f"  {line.strip()}")
    cs.phase_kernel_vs_plain(dev, "mode_search_encode_plane", "3b",
                             wide_bits=True)
    cs.phase_wavefront_vs_plain(dev)
    cs.phase_wavefront_scan_vs_plain(dev)
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    _, bits = cs.encode_frame_closed_loop(frame, cs.MODE_SEARCH, device=dev)
    cs.phase_decode_vs_plain(dev, bits, gpu)
    if "--times" in sys.argv[1:]:
        cs.wavefront_times(dev, gpu)
        cs.scan_times(dev, gpu)
    cs.log(f"torch_wavefront_phase: passed in "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
