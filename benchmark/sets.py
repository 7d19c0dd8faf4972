"""Runs of one cell, one process each, one after another, with the
spread of each metric: what the bounds are set from.

    python3 benchmark/sets.py --workload <cell> --seeds 11,12,13 --seconds 20 [--trace 1] [--out FILE]

Each run is `benchmark/run.py` with its seed; its result line, exit code
and wall time go to `--out` (JSON lines; by default under build/bench/),
and a summary follows: for each metric the values, the median and the
spread, the distance between the first and third quartiles
(`statistics.quantiles(values, n=4)`) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values: list) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    out = Path(a.out or HERE.parent / "build" / "bench" / "sets" /
               f"{a.workload}.t{a.trace}.{int(time.time())}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in a.seeds.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(HERE / "run.py"), "--workload", a.workload,
             "--seed", seed, "--seconds", str(a.seconds), "--trace",
             str(a.trace)], capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"seed": int(seed), "rc": proc.returncode, "wall_s": wall,
               "result": result, "stderr_tail": proc.stderr[-3000:]}
        rows.append(row)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        short = {k: v["value"] for k, v in (result or {}).get(
            "metrics", {}).items()}
        print(f"seed {seed} rc {proc.returncode} wall {wall:.1f} s correct "
              f"{(result or {}).get('correct')} attempted "
              f"{(result or {}).get('attempted')} {short} calls_ms "
              f"{(result or {}).get('calls_ms')} checks "
              f"{(result or {}).get('checks')}", flush=True)
        if result is None:
            print(proc.stderr[-2000:], flush=True)
    names = sorted({k for r in rows if r["result"]
                    for k in r["result"]["metrics"]})
    for k in names:
        vals = [r["result"]["metrics"][k]["value"] for r in rows
                if r["result"] and k in r["result"]["metrics"]]
        print(f"{k}: median {statistics.median(vals)!r} spread "
              f"{spread(vals)!r} values {vals!r}", flush=True)
    print(f"results in {out}")


if __name__ == "__main__":
    main()
