"""Spans and the device trace of a `--trace 1` run.

Spans are recorded from the benchmark's files: `Spans` wraps module
attributes that the program looks up at call time (each call opens a
`torch.profiler.record_function` range named "bench.<span>") and puts
them back on exit, so the program is not edited.  `torch.profiler`
records those ranges and every kernel, copy and fill on the card on one
clock; `Trace` reads them from the profiler's raw events.
"""

from __future__ import annotations

import importlib
from collections import defaultdict

import torch

PREFIX = "bench."


class Spans:
    """Context manager: `targets` are (module, attribute, span) triples;
    while open, each call of module.attribute is the span `span`."""

    def __init__(self, targets):
        self.targets = list(targets)
        self.saved = []

    def __enter__(self):
        for mod_name, attr, span in self.targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, _spanned(fn, PREFIX + span))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved.clear()
        return False


def _spanned(fn, name):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    call.__wrapped__ = fn
    return call


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")()) * 1000


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


class Trace:
    """The traced window: host spans and device activity, in ns.

    The window runs from the first "bench.frame" span's start to the last
    one's end; device activity is clipped to it."""

    def __init__(self, spans: list, device: list, frame_span: str = "frame"):
        self.spans = sorted(spans, key=lambda s: s[1])
        frames = [s for s in self.spans if s[0] == frame_span]
        self.frames = len(frames)
        if not frames:
            raise ValueError(f"the trace holds no {frame_span!r} span")
        self.start = frames[0][1]
        self.end = max(s[2] for s in frames)
        self.device = sorted(
            ((n, max(a, self.start), min(b, self.end), k)
             for n, a, b, k in device if b > self.start and a < self.end),
            key=lambda e: e[1])

    @classmethod
    def from_profiler(cls, prof, frame_span: str = "frame") -> "Trace":
        spans, device = [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if name.startswith(PREFIX):
                if not _is_device(ev):
                    spans.append((name[len(PREFIX):], start, end))
            elif _is_device(ev):
                device.append((name, start, end, _kind(name)))
        return cls(spans, device, frame_span)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy(self) -> list:
        """Merged intervals in which some operation ran on the device."""
        out = []
        for _, a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def device_s(self, *, kinds=("kernel", "memcpy", "memset"),
                 names=None) -> float:
        """Summed device time of operations of `kinds` whose name holds
        one of `names` (any name where None)."""
        return sum(b - a for n, a, b, k in self.device
                   if k in kinds and (names is None
                                      or any(x in n for x in names))) * 1e-9

    def span_s(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name) * 1e-9

    def top_ops(self, count: int = 10) -> list:
        by = defaultdict(int)
        for n, a, b, _ in self.device:
            by[n[:160]] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:count]
        return [[n, t * 1e-9] for n, t in top]

    def idle_gaps(self, count: int = 10) -> list:
        """Idle time of the device in the window, split by the innermost
        span open on the host meanwhile ("harness" outside every span),
        the largest first."""
        gaps, t = [], self.start
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        by = defaultdict(int)
        segs = self._innermost()
        j = 0
        for a, b in gaps:
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < b:
                lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
                by[segs[k][2]] += hi - lo
                k += 1
        top = sorted(by.items(), key=lambda kv: -kv[1])[:count]
        return [[n, t * 1e-9] for n, t in top]

    def _innermost(self) -> list:
        """The window cut into (start, end, name) segments by the
        innermost open span (spans nest: one host thread)."""
        marks = sorted([(a, 1, i) for i, (_, a, _) in enumerate(self.spans)]
                       + [(b, 0, i) for i, (_, _, b) in enumerate(self.spans)])
        segs, stack, t = [], [], self.start
        for when, opening, i in marks:
            when = min(max(when, self.start), self.end)
            if when > t:
                segs.append((t, when,
                             self.spans[stack[-1]][0] if stack else "harness"))
                t = when
            if opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        if self.end > t:
            segs.append((t, self.end, "harness"))
        return segs
