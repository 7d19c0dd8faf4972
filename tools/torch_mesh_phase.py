"""Run the multi-device phase of `chip_smoke.py` (phase 9) alone.

    python3 tools/torch_mesh_phase.py        # from the root of a checkout

Builds the kernels, writes the seeded 16-frame 1080p file of phases
4f-4g, encodes its first 8 frames closed loop one by one (the recon
that 9d's decode must give), then runs `chip_smoke.phase_mesh`: on
every visible card when there are two or more, else on a logical
(2, 2) mesh on the one card.  Each line carries the card's name and
power limit; exits non-zero when there is no card or a check fails.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mesh_phase: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    cs.log(f"{gpu}; {torch.cuda.device_count()} card(s)")
    cs.build.build_libraries()
    frames = cs.sequence_frames(cs.SEQ_FRAMES, cs.H, cs.W, cs.SEED + 3)
    with tempfile.TemporaryDirectory() as tmp:
        src = cs.write_yuv(os.path.join(tmp, "seq.yuv"), frames)
        recon = b"".join(
            cs.encode_frame_closed_loop(f, cs.EncoderConfig(), device=dev)[0]
            .to_yuv420p() for f in frames[:cs.MESH_SEQ_FRAMES])
        cs.phase_mesh(dev, tmp, src, frames, recon, gpu)
    cs.log(f"torch_mesh_phase: passed in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
