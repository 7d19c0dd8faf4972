"""Run the decode kernel's phases of `chip_smoke.py` (3f, 6d) alone.

    python3 tools/torch_decode_phase.py      # from the root of a checkout

Builds the kernels (printing the decode library's registers and spills),
encodes the seeded 1080p 4:2:0 frame closed loop on the card under the
default config and the mode search, decodes each stream with
`decode_frame` (3 launches of the decode kernel, == the recon), then
runs `chip_smoke.phase_decode_vs_plain` (3f: the kernel == its plain
version), `chip_smoke.decode_times` and `chip_smoke.decode_frame_split`
(6d: kernel times per N, bound, the frame call with its host parse and
device busy share).  Each line carries the card's name and power limit;
exits non-zero when there is no card or a check fails.
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
        print("torch_decode_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(gpu)
    info = cs.build.build_libraries()["decode"]
    cs.log(f"decode library built in {info.seconds:.2f} s"
           f"{' (cached)' if info.cached else ''}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {line.strip()}")
    frame = cs.make_frame(np.random.default_rng(cs.SEED))
    streams = {}
    for label, config in (("default", cs.EncoderConfig()),
                          ("mode search", cs.MODE_SEARCH)):
        recon, bits = cs.encode_frame_closed_loop(frame, config, device=dev)
        decoded = cs.counted_decode(f"{label} decode_frame", 3,
                                    lambda: cs.decode_frame(bits, device=dev))
        if not cs.same_frames(decoded, recon):
            raise SystemExit(f"{label}: decode_frame on the card != recon")
        cs.log(f"{label}: decode_frame on the card == recon, 3 launches")
        streams[label] = bits
    cs.phase_decode_vs_plain(dev, streams["mode search"], gpu)
    cs.decode_times(dev, frame, gpu)
    for label, bits in streams.items():
        cs.decode_frame_split(dev, bits, label, gpu)
    cs.log(f"torch_decode_phase: passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
