"""What a traced run records, from outside the program.

- :class:`Spans`: a synchronised timer around each section function a
  metric names (``"package.module:function"``), patched onto its module
  for the span phase and restored after; each span's seconds and calls.
- :class:`KernelCalls`: each call of the hand-written kernels' wrappers
  (K1-K5) in the profiled phase, with what its bound needs counted from
  its own inputs (rows moved, slots alive); the counting kernels run
  inside a ``bench::count`` range, which :func:`read_trace` leaves out.
- :func:`read_trace`: the profiler's chrome trace of the profiled phase:
  the union of device activity, each kernel's device time, the launches,
  and the longest idle gaps named by the host operation under them.
- :func:`read_counters`, :func:`counter_change`: copies of the program's
  counters (dicts of numbers, ``"package.module:NAME"``) before and after
  the window, and what the window added; the program's counters are
  never reset.
"""

from __future__ import annotations

import importlib
import json
import math
import time
from collections import defaultdict

import torch

from . import roofline

WINDOW_RANGE = "bench::window"
COUNT_RANGE = "bench::count"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def resolve(site: str):
    """(module, attribute) of ``"package.module:attribute"``."""
    mod, attr = site.split(":")
    return importlib.import_module(mod), attr


def read_counters(sites) -> dict:
    """``{site: a copy of the dict}`` of each ``"package.module:NAME"`` in
    ``sites`` that the program has; a site whose module or name it lacks
    (an older commit) is left out."""
    out = {}
    for site in dict.fromkeys(sites):
        name, attr = site.split(":")
        try:
            mod = importlib.import_module(name)
        except ModuleNotFoundError as e:
            if e.name and (name == e.name or name.startswith(e.name + ".")):
                continue
            raise
        counts = getattr(mod, attr, None)
        if isinstance(counts, dict):
            out[site] = dict(counts)
    return out


def counter_change(before: dict, after: dict) -> dict:
    """``{site: {name: after - before}}`` of two :func:`read_counters`."""
    return {site: {k: v - before[site].get(k, 0) for k, v in now.items()}
            for site, now in after.items()}


class Spans:
    """Within ``with``: every site wrapped by a timer that calls ``sync``
    before and after it.  ``seconds[site]``, ``calls[site]``."""

    def __init__(self, sites, sync):
        self.sites = tuple(dict.fromkeys(sites))
        self.sync = sync
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._saved = []

    def _wrap(self, site, fn):
        def timed(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            self.seconds[site] += time.perf_counter() - t0
            self.calls[site] += 1
            return out
        return timed

    def __enter__(self):
        for site in self.sites:
            mod, attr = resolve(site)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(site, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False


def _count(fn):
    with torch.profiler.record_function(COUNT_RANGE):
        return fn()


class KernelCalls:
    """Within ``with``: the K1-K5 wrappers of the program recorded call by
    call.  :meth:`bounds` (after the phase) gives ``[(kernel, ms)]``."""

    WRAPPERS = (("wrf_partmc_tpu_torch.ops.tridiag:thomas_solve", "K1"),
                ("wrf_partmc_tpu_torch.ops.place:scatter_rows_cuda", "K2"),
                ("wrf_partmc_tpu_torch.ops.place:gather_rows_cuda", "K3"),
                ("wrf_partmc_tpu_torch.ops.threefry:threefry_draw", "K4"),
                ("wrf_partmc_tpu_torch.ops.mie_fit:mie_fit_bulk", "K5"))

    def __init__(self):
        self.calls = []            # (kernel, bound(**counts), {count name: 0-d tensor or int})
        self._saved = []

    def _record(self, kernel, args, kwargs):
        if kernel == "K1":
            dl, d, du, fields = args[:4]
            coef = sum(math.prod(t.shape) for t in (dl, d, du))
            n_f = sum(math.prod(f.shape) for f in fields)
            self.calls.append(("K1", lambda: roofline.k1_bound(coef, n_f), {}))
        elif kernel == "K2":
            x, dst, L2 = args[:3]
            C, CH, L1 = x.shape
            moved = _count(lambda: ((dst >= 0) & (dst < L2)).sum())
            self.calls.append(("K2", lambda moved: roofline.scatter_bound(C, CH, L1, L2, moved),
                               {"moved": moved}))
        elif kernel == "K3":
            x, src = args[:2]
            C, CH, L1 = x.shape
            L2 = src.shape[1]

            def distinct():
                valid = (src >= 0) & (src < L1)
                hit = torch.zeros((C, L1 + 1), dtype=torch.bool, device=src.device)
                hit.scatter_(1, torch.where(valid, src, L1).long(), True)
                return hit[:, :L1].sum()
            self.calls.append(("K3", lambda rows: roofline.gather_bound(C, CH, L1, L2, rows),
                               {"rows": _count(distinct)}))
        elif kernel == "K4":
            mode, key, shape = args[:3]
            device = args[3] if len(args) > 3 else kwargs["device"]
            lo = args[4] if len(args) > 4 else kwargs.get("lo", 0.0)
            span = args[5] if len(args) > 5 else kwargs.get("span", 1.0)
            blk = args[6] if len(args) > 6 else kwargs.get("block")
            n = math.prod(int(s) for s in shape)
            draw = (tuple(key), tuple(int(s) for s in shape), device, lo, span, blk)
            self.calls.append(("K4", lambda **c: roofline.k4_bound(mode, n, blk is not None, **c),
                               {"normal": draw} if mode == "normal" else {}))
        else:
            diam, _n, _k, live_num = args[:4]
            wl = args[5] if len(args) > 5 else kwargs["wavelengths"]
            C, P = diam.shape
            live = _count(lambda: (live_num != 0).sum())
            self.calls.append(("K5", lambda live: roofline.k5_bound(C, P, len(wl), live),
                               {"live": live}))

    def __enter__(self):
        for site, kernel in self.WRAPPERS:
            mod, attr = resolve(site)
            fn = getattr(mod, attr)

            def wrapped(*args, _fn=fn, _k=kernel, **kwargs):
                out = _fn(*args, **kwargs)
                self._record(_k, args, kwargs)
                return out
            for k in ("launches", "shapes"):
                if hasattr(fn, k):
                    setattr(wrapped, k, getattr(fn, k))
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
        return False

    def bounds(self) -> list:
        """[(kernel, bound ms)] of every call recorded; a normal draw's
        branches are counted on its uniform, drawn again by the
        reference's plain threefry."""
        from .reference.wpmc_plain.utils import rng as plain_rng

        out = []
        for kernel, fn, counts in self.calls:
            args = {}
            for name, c in counts.items():
                if name == "normal":
                    key, shape, device, lo, span, blk = c
                    block = None if blk is None else plain_rng.Block(*blk[:6])
                    u = plain_rng.draw_plain("uniform", plain_rng.Key(key), shape, device,
                                             lo, span, block).double()
                    a = u * u
                    args["n_small"] = int((a < 0.41421356237309504880).sum())
                    args["n_ge5"] = int((-torch.log1p(-a) >= 5.0).sum())
                    del u, a
                else:
                    args[name] = int(c)
            out.append((kernel, fn(**args)[0]))
        return out


def _union(intervals):
    """Merged, sorted [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read_trace(path: str, top: int = 10) -> dict:
    """The profiled window of a chrome trace (``bench::window``): its
    seconds, the seconds some device operation ran (union), K1-K5's device
    seconds, the kernels launched, the device operations that took most
    time and the longest idle gaps, each named by the innermost host
    operation running at its middle.  Device operations launched inside a
    ``bench::count`` range are left out."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW_RANGE and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"read_trace: {len(win)} '{WINDOW_RANGE}' ranges in {path}")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    counting = defaultdict(list)
    for e in events:
        if e.get("name") == COUNT_RANGE and e.get("cat") == "user_annotation":
            counting[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    skip = set()
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and e["tid"] in counting and any(
                a <= e["ts"] <= b for a, b in counting[e["tid"]]):
            skip.add(e.get("args", {}).get("correlation"))
    skip.discard(None)
    dev, by_name, k_time, launches = [], defaultdict(float), defaultdict(float), 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("args", {}).get("correlation") in skip:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e["name"]] += (t - s) * 1e-6
        if e["cat"] == "kernel":
            launches += 1
            k = roofline.kernel_of(e["name"])
            if k is not None:
                k_time[k] += (t - s) * 1e-6
    busy = _union(dev)
    gaps = [(a[1], b[0]) for a, b in zip([[w0, w0]] + busy, busy + [[w1, w1]]) if b[0] > a[1]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]         # longest first
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "cpu_op" and "dur" in e)

    def under(t):
        name = "host outside torch operations"
        for s, end, n in host:
            if s > t:
                break
            if end >= t:
                name = n                     # the last to start: the innermost
        return name
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "kernel_s": dict(k_time),
            "launches": launches,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": [[under(0.5 * (a + b)), (b - a) * 1e-6] for a, b in gaps]}
