"""The benchmark of the PyTorch/CUDA port, one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Finds the cell in BENCHMARK.json and its
files in this folder (`benchlib/spec.py`), makes the cell's frames from
the seed, sets up the cell's entry and warms up its shapes (the set-up
time), sends the frames in a closed loop for `--seconds`, then checks
what the window produced against the plain reference (`plainref/`).
With `--trace 0` it reports the cell's end-to-end metrics; with
`--trace 1` the window runs under torch.profiler with spans around the
program's layers and it reports the per-layer metrics.  The last line
of standard output is one JSON object; the numbers compared, each with
its limit, are the last lines of standard error and the result's last
key.  It exits non-zero without a result where CUDA or the cell's chips
are missing, or where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (HERE, ROOT):           # the benchmark's modules, the port
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

# Build and kernel caches at fixed paths inside the checkout (the port's
# own builds go to build/nanohevc_tpu_torch/ beside these).
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "bench" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "bench" / "triton"}
FORBIDDEN = {"jax", "jaxlib", "flax", "nanohevc_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot),
    compared whole, is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None, *, device: str = "cuda", overrides=None) -> dict:
    """One run; returns the result it prints.  `device` and `overrides`
    (cell-file keys replaced, such as a small frame size) serve the
    benchmark's own CPU tests, which skip the look for a card."""
    args = parse(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    import numpy as np
    import torch

    from benchlib import spec, traffic, window
    from benchlib.trace import Spans, Trace

    cell = spec.find_cell(args.workload, ROOT, HERE)
    work = {**cell.config["frame"], **cell.workload, **(overrides or {})}
    if device == "cuda":
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this benchmark runs "
                 "on a CUDA card only")
        if torch.cuda.device_count() < cell.chips:
            fail(f"{cell.name} needs {cell.chips} cards, "
                 f"{torch.cuda.device_count()} visible")

    entry_mod = spec.load_module("entries", work["entry"], HERE)
    frames = traffic.make_frames(args.seed, work["frames"], work["height"],
                                 work["width"], work["noise"],
                                 cell.config["encoder"]["bit_depth"])
    entry = entry_mod.Entry(cell.config, work, frames, device, args.seed)
    entry.warm_up()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    kept = {}

    def keep(i, out):
        if entry.keep(i):
            kept[i] = out

    before = entry.counters()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with Spans(entry.spans()), profile(activities=acts) as prof:
            win = window.run(entry, args.seconds, keep,
                             around=lambda: record_function("bench.frame"))
            if device == "cuda":
                torch.cuda.synchronize()
    else:
        win = window.run(entry, args.seconds, keep)
    counters = {k: v - before.get(k, 0) for k, v in entry.counters().items()}

    leaked = forbidden_modules()
    if leaked:
        fail(f"JAX or the JAX package is loaded: {leaked}", 3)
    peak = 0
    if device == "cuda":
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(cell.chips))
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": cell.chips, "memory_peak_bytes": peak}

    ctx = Context(cell=cell, work=work, window=win, setup_s=setup_s,
                  counters=counters, trace=None)
    result = {}
    if args.trace:
        ctx.trace = Trace.from_profiler(prof)
        del prof
        dev_info["busy_s"] = ctx.trace.busy_s
        dev_info["window_s"] = ctx.trace.window_s
        metrics = read_metrics(cell.per_layer, ctx)
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    else:
        metrics = read_metrics(cell.end_to_end, ctx)

    # The program's wrapper and the trace's millions of records go before
    # the reference runs.
    entry.release()
    del ctx
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = entry.check(kept, win.attempted)
    leaked = forbidden_modules()
    if leaked:
        fail(f"JAX or the JAX package is loaded after the check: {leaked}", 3)
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    correct = win.failed == 0 and all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": dev_info}
    out.update(result)
    # The window's median call beside its tail, for the record (the
    # driver reads neither).
    out["calls_ms"] = {q: float(np.percentile(win.latencies_s, p)) * 1e3
                       for q, p in (("median", 50), ("p95", 95))}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    print(json.dumps(out), flush=True)
    return out


class Context:
    """What a metric's reader may read: the cell and its work, the
    window's timing, the set-up time, the counters' changes over the
    window, the work counts (`roofline_s`) and, in a traced run, the
    `Trace`."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def roofline_s(self, kernel: str) -> float:
        """Least seconds of `kernel`'s work in one call of the entry,
        from `roofline/<kernel>.py`."""
        from benchlib import spec
        return spec.load_module("roofline", kernel, HERE).least_seconds(
            self.cell.config, self.work)[0]


def read_metrics(metrics, ctx) -> dict:
    """Each metric's reader, `metrics/<name>.py`; a reader that finds
    nothing to read returns None and the metric is left out."""
    from benchlib import spec
    out = {}
    for m in metrics:
        value = spec.load_module("metrics", m["name"], HERE).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


if __name__ == "__main__":
    main()
