"""The program's own stage spans and counters, read after a traced window.

The port records them itself (`nanohevc_tpu_torch.utils.tracing`): while
a torch profiler records, each `span(name)` adds its host time to
`tracing.SPANS` and each `count(name, n)` adds to `tracing.COUNTS`.  The
profiler records over the traced window alone, so their totals are the
window's.  A program without them (no `SPANS` or `COUNTS`, or no such
name) gives None, and the metric is left out.
"""

from __future__ import annotations

import importlib

TRACING = "nanohevc_tpu_torch.utils.tracing"


def _registry(attr: str):
    try:
        mod = importlib.import_module(TRACING)
    except ImportError:
        return None
    return getattr(mod, attr, None)


def span_ms_per_frame(ctx, name: str):
    """Host ms of the program's span `name`, per frame of the window."""
    t = ctx.trace
    if t is None or not t.frames:
        return None
    totals = getattr(_registry("SPANS"), "totals", None) or {}
    s = totals.get(name)
    return s / t.frames * 1e3 if s else None


def count_per_frame(ctx, name: str):
    """The program's counter `name`, per frame of the window."""
    t = ctx.trace
    if t is None or not t.frames:
        return None
    n = (_registry("COUNTS") or {}).get(name)
    return n / t.frames if n else None
