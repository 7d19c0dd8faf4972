"""Tracing / profiling helpers, port of `nanohevc_tpu/utils/tracing.py`.

- trace_region: names a host-side region in an active torch.profiler
  trace (`torch.profiler.record_function`, where the JAX package used
  `jax.profiler.TraceAnnotation`);
- Stopwatch + throughput_stats: wall-clock Mpix/s counters for the
  sequence runner's per-run stats, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator


@contextlib.contextmanager
def trace_region(name: str) -> Iterator[None]:
    """Annotate a host-side region in the active profiler trace."""
    import torch.profiler

    with torch.profiler.record_function(name):
        yield


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


def throughput_stats(pixels: int, seconds: float) -> Dict[str, float]:
    """Uniform Mpix/s summary used by the sequence runner and bench."""
    seconds = max(seconds, 1e-9)
    return {
        "pixels": pixels,
        "seconds": round(seconds, 4),
        "mpix_per_s": round(pixels / seconds / 1e6, 6),
    }
