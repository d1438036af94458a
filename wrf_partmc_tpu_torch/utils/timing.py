"""Section timers, named spans and the host memory tracker.

The port's own copy of ``wrf_partmc_tpu/utils/timing.py``: named cumulative
wall-clock timers and the getrusage maxrss tracker.  Work on a CUDA device
is asynchronous, so a timer given ``sync`` (``torch.cuda.synchronize``)
calls it before it reads the clock at the end of a section, and the section
holds the device time of the work it queued.

:func:`span` names a section of the program for a profiler: while a
``torch.profiler`` records, it opens a ``record_function`` range, which the
chrome trace holds as a ``user_annotation`` on the host thread, on the
device kernels' clock (each kernel carries the correlation id of its
launch).  With no profiler recording it costs one attribute read and
returns a shared null context, where ``record_function`` would build a
profiler object on every call, profiler or not.
"""

from __future__ import annotations

import resource
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch
import torch.autograd.profiler as _profiler

_NULL = nullcontext()


def span(name: str):
    """A context naming the section ``name`` (a constant string) in a
    profiler's trace; a shared null context when no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


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
            with span(name):
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
