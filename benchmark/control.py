"""The control of a cell's check: the plain reference, computed in the
precision below the one the configuration states, put in the program's
place.  Its RD costs (distortion plus lambda-weighted bits, float32 in
the configuration) are added in bfloat16; its outputs (recon, levels,
modes, CTB SAO parameters, and the bytes its own bitstream writer makes
of them) go through the cell's check exactly as a window's would.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

Prints each seed's numbers beside their limits; a sound check reads
them above the limits.  No window runs: the frames the check samples
are encoded once, at the cell's size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
for _p in (HERE, HERE.parent):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

CONTROL_DTYPE = "bfloat16"


def control_outputs(entry, ids, dtype) -> dict:
    """{frame: (recon, bytes, (levels, modes, sao))} of the reference
    at `dtype`, in the shapes the entry keeps from a window."""
    from plainref import bitstream, encoder

    h, w = int(entry.work["height"]), int(entry.work["width"])
    outs = encoder.encode_frames([entry.raw[f] for f in ids], entry.settings,
                                 entry.device, dtype)
    kept = {}
    for f, o in zip(ids, outs):
        recon = SimpleNamespace(**{p.lower(): SimpleNamespace(data=o["recon"][p])
                                   for p in "YUV"})
        bits = bitstream.assemble(w, h, entry.settings, o["levels"],
                                  o["modes"], o["sao_ctb"])
        kept[f] = (recon, bits, (o["levels"], o["modes"], o["sao_ctb"]))
    return kept


def run_control(workload: str, seed: int, device: str, overrides=None) -> list:
    """The cell's check numbers, (name, value, limit), with the control
    in the program's place.  `overrides` (cell-file keys replaced, such
    as a small frame size) serve the benchmark's own tests."""
    import torch

    from benchlib import spec, traffic

    cell = spec.find_cell(workload, HERE.parent, HERE)
    work = {**cell.config["frame"], **cell.workload, **(overrides or {})}
    frames = traffic.make_frames(seed, work["frames"], work["height"],
                                 work["width"], work["noise"],
                                 cell.config["encoder"]["bit_depth"])
    entry = spec.load_module("entries", work["entry"], HERE).Entry(
        cell.config, work, frames, device, seed)
    try:
        ids, _ = entry.checked(len(frames))
        kept = control_outputs(entry, ids, getattr(torch, CONTROL_DTYPE))
        return entry.check(kept, len(frames))
    finally:
        entry.release()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("control: needs a CUDA card")
    for seed in a.seeds.split(","):
        t0 = time.perf_counter()
        checks = run_control(a.workload, int(seed), "cuda")
        print(json.dumps({"workload": a.workload, "seed": int(seed),
                          "dtype": CONTROL_DTYPE,
                          "seconds": time.perf_counter() - t0,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks},
                          "fails": any(v > lim for _, v, lim in checks)}),
              flush=True)


if __name__ == "__main__":
    main()
