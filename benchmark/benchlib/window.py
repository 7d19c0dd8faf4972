"""The measured window: one caller in a closed loop.

Each call starts when the previous one has returned, and is timed on
the host clock from the call to its return.  Calls start until
`seconds` have passed; the window ends when the last one returns, so
its wall time covers all the work it holds.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    latencies_s: list = field(default_factory=list)
    failed: int = 0
    start: float = 0.0
    end: float = 0.0

    @property
    def attempted(self) -> int:
        return len(self.latencies_s)

    @property
    def wall_s(self) -> float:
        return self.end - self.start


def run(call, seconds: float, keep, around=None) -> Window:
    """Call `call(i)` for i = 0, 1, ... for `seconds`; `keep(i, out)`
    sees each output (None where the call raised).  `around`, where
    given, is a context-manager factory each call runs inside."""
    w = Window()
    w.start = time.perf_counter()
    deadline = w.start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline and i:
            break
        out = None
        try:
            if around is None:
                out = call(i)
            else:
                with around():
                    out = call(i)
        except Exception:
            w.failed += 1
            if w.failed == 1:
                traceback.print_exc(file=sys.stderr)
        w.latencies_s.append(time.perf_counter() - t0)
        keep(i, out)
        i += 1
    w.end = time.perf_counter() if i else w.start
    return w
