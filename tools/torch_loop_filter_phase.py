"""Run the loop filters' phases of `chip_smoke.py` (3i, 6i) alone.

    python3 tools/torch_loop_filter_phase.py            # from a checkout's root
    python3 tools/torch_loop_filter_phase.py --times

Builds the kernels (printing the deblock and SAO libraries' registers
and spills) and runs `chip_smoke.phase_filters_vs_plain` (3i: each
filter kernel == its plain version on the card).  `--times` adds
`chip_smoke.filter_times` (6i: each kernel and its plain version a
padded 1080p plane through a CUDA graph, beside its bound), 8b's stage
times (`filter_stage_times`: kernels beside the plain ops, stream and
CUDA-graph time) and the 1080p closed-loop frame call and its device
part without filters, with deblock+sao and with deblock+sao_ctb, under
the default config and the mode search (`frame_call_ms`).  Each line
carries the card's name and power limit; exits non-zero when there is
no card or a check fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--times", action="store_true",
                        help="also time the kernels, the stages and the "
                             "filtered frame calls")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_loop_filter_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    for stem, info in cs.build.build_libraries().items():
        cs.log(f"built {stem} in {info.seconds:.2f} s")
        if stem in ("deblock", "sao"):
            for line in info.log.splitlines():
                if "registers" in line or "spill" in line:
                    cs.log(f"  {line.strip()}")
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    cs.phase_filters_vs_plain(dev, frame, gpu)
    if args.times:
        cs.filter_times(dev, frame, gpu)
        cs.filter_stage_times(dev, frame, gpu)
        for label, base in (("default", cs.EncoderConfig()),
                            ("mode search", cs.MODE_SEARCH)):
            for filters in ("none", "deblock+sao", "deblock+sao_ctb"):
                cfg = (base if filters == "none" else
                       cs.filtered(base, **cs.FILTER_CONFIGS[filters]))
                wall, dev_ms = cs.frame_call_ms(dev, frame, cfg)
                cs.log(f"[8b] {label}, filters {filters}: 1080p 4:2:0 "
                       f"closed-loop frame call {wall:.2f} ms (median of 3), "
                       f"device part {dev_ms:.2f} ms [{gpu}]")
    cs.log(f"torch_loop_filter_phase: passed in "
           f"{time.perf_counter() - t0:.1f} s [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
