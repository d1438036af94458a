"""Section timers and the host memory tracker.

The port's own copy of ``wrf_partmc_tpu/utils/timing.py``: named cumulative
wall-clock timers and the getrusage maxrss tracker.  Work on a CUDA device
is asynchronous, so a timer given ``sync`` (``torch.cuda.synchronize``)
calls it before it reads the clock at the end of a section, and the section
holds the device time of the work it queued.
"""

from __future__ import annotations

import resource
import time
from collections import defaultdict
from contextlib import contextmanager


class SectionTimers:
    """Named cumulative wall-clock timers (start_timing/end_timing)."""

    def __init__(self, sync=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync = sync

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"  {name:<28s} {tot:9.3f} s  ({n} calls, "
                         f"{tot / max(n, 1) * 1e3:8.2f} ms/call)")
        return "\n".join(lines)


def memtrack_mb() -> float:
    """Max resident set size of this process in MB."""
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return kb / 1024.0
