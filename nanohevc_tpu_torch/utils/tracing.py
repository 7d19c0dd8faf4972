"""Tracing / profiling helpers: the port's stages and counters.

- span(name): one stage of a frame call ("frame.upload", "frame.fetch",
  "frame.convert", "entropy.sao", "entropy.modes", "entropy.scan",
  "entropy.residual"; "wavefront.launch", the wavefront kernel
  wrapper's host work on the card's path).  While a torch profiler
  records, it opens the host range "nhevc.<name>" in the profiler's
  trace, on the clock of every kernel and copy on the card, and adds
  its host time to `SPANS`;
  with no profiler recording it reads one flag and returns the shared
  `NULL_SPAN`.  The range is an operator range, not a
  `record_function` user annotation: the profiler mirrors a user
  annotation onto the card's timeline over the work launched inside it,
  and a stage that waits for the card would then read as device time;
- count(name, n): adds n to `COUNTS[name]` while a profiler records
  (the bytes a frame call moves: "frame.bytes_up", "frame.bytes_down";
  the times its host waits for the card's outputs: "frame.waits"; the
  blocks the CABAC coder reads in their scan order:
  "entropy.scan_order_blocks"; the blocks the wavefront kernel codes,
  over each batch's padded geometry: "wavefront.blocks");
- reset(): empties `SPANS` and `COUNTS`;
- Stopwatch + throughput_stats: wall-clock Mpix/s counters for the
  sequence runner's per-run stats, as in the JAX package.

To see where a frame call's time goes, run the frame API under the
profiler; each idle gap of the card then lies under a named stage:

    from torch.profiler import ProfilerActivity, profile
    from nanohevc_tpu_torch.utils import tracing

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        recon, bits = encode_frame_closed_loop(frame, config)
    prof.export_chrome_trace("frame.json")    # Perfetto, chrome://tracing
    print(tracing.SPANS.report(), tracing.COUNTS)
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _Range

PREFIX = "nhevc."


@dataclass
class Stopwatch:
    """Accumulating wall-clock timer keyed by stage name."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k],
                "mean_ms": round(1e3 * v / self.counts[k], 3)}
            for k, v in self.totals.items()
        }


# Host time of each span and the counters, summed over every frame call
# made while a profiler recorded.
SPANS = Stopwatch()
COUNTS: Dict[str, int] = {}
NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """The stage `name`: a profiler range and a `SPANS` entry while a
    profiler records, `NULL_SPAN` otherwise."""
    if not _profiler._is_profiler_enabled:
        return NULL_SPAN
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name: str) -> Iterator[None]:
    with _Range(PREFIX + name), SPANS.time(name):
        yield


def count(name: str, n: int) -> None:
    """Add n to `COUNTS[name]` while a profiler records."""
    if _profiler._is_profiler_enabled:
        COUNTS[name] = COUNTS.get(name, 0) + int(n)


def reset() -> None:
    """Empty `SPANS` and `COUNTS`."""
    SPANS.totals.clear()
    SPANS.counts.clear()
    COUNTS.clear()


def throughput_stats(pixels: int, seconds: float) -> Dict[str, float]:
    """Uniform Mpix/s summary used by the sequence runner and bench."""
    seconds = max(seconds, 1e-9)
    return {
        "pixels": pixels,
        "seconds": round(seconds, 4),
        "mpix_per_s": round(pixels / seconds / 1e6, 6),
    }
