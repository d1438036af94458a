"""The program's named spans in the profiled phase's chrome trace.

The coupled step names its sections with ``utils.timing.span``: ``wpmc.step``
around the whole step, one top-level span a section (``wpmc.solve_step``,
``wpmc.transport``, ...), and children named below their parent
(``wpmc.transport.t1``).  While a profiler records, each is a
``user_annotation`` range on the host thread, on the clock of the device
operations, which carry the correlation id of their launch.  :func:`read`
gives each span, per step of the window:

- ``host_ms``: its ranges' wall time, less the ``bench::count`` ranges in them;
- ``busy_ms``: the union of the device operations launched while the host
  was inside it (an operation launched in a child counts in its parent too);
- ``idle_ms``: the window's device-idle time (the window less the union of
  all its device operations) that passed while the host was inside it, cut
  at the range's edges;
- ``launches``: the kernels launched inside it;

and ``outside`` the same for whatever falls in no top-level span: the host
between steps and the step's own code between its sections.  The top-level
spans and ``outside`` split the window: their ``idle_ms`` add up to the
window's idle time and their ``launches`` to :func:`trace.read_trace`'s.
Device operations launched under ``bench::count`` are left out, as
``read_trace`` leaves them out.  :func:`layers` sums the dycore's and the
particles' sections.

On the card, one cell's profiled phase alternately with the spans on and
with the span check forced off, each phase's sections and costs a JSON line:

    python -m benchmark.sections --workload <cell> --seed <n> [--seconds 2] [--pairs 3]
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from . import trace

PREFIX = "wpmc."
STEP = "wpmc.step"
OUTSIDE = "outside"
LAYERS = {"dycore": ("wpmc.solve_step", "wpmc.vertical_diffusion"),
          "particles": ("wpmc.emission", "wpmc.transport", "wpmc.inflow", "wpmc.deposition",
                        "wpmc.rebalance")}


def top_level(name: str) -> bool:
    """A section of the step: ``wpmc.<section>``, not the step itself."""
    return name.startswith(PREFIX) and name.count(".") == 1 and name != STEP


def _overlap(ranges, merged) -> float:
    """Length of the sorted, merged intervals ``merged`` inside each of
    ``ranges``, summed."""
    starts = [m[0] for m in merged]
    total = 0.0
    for a, b in ranges:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            total += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    return total


def _stats(ops, ranges, idle, counting, steps) -> dict:
    """``ops``: [(start, end, is kernel)] attributed to the span; ``ranges``:
    [(tid, a, b)] of its host ranges."""
    host = sum(b - a for _, a, b in ranges)
    for tid, a, b in ranges:
        host -= _overlap([(a, b)], counting.get(tid, []))
    busy = trace._union((s, t) for s, t, _ in ops)
    return {"host_ms": 1e-3 * host / steps,
            "busy_ms": 1e-3 * sum(t - s for s, t in busy) / steps,
            "idle_ms": 1e-3 * _overlap([(a, b) for _, a, b in ranges], idle) / steps,
            "launches": sum(1 for *_, k in ops if k) / steps}


def read(path: str) -> dict:
    """``{span: {"host_ms", "busy_ms", "idle_ms", "launches"}}`` per step of
    the profiled window (``bench::window``) of the chrome trace at ``path``,
    the steps counted as its ``wpmc.step`` ranges, with ``outside``; ``{}``
    where the program names no step (a program without spans)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events
           if e.get("name") == trace.WINDOW_RANGE and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"sections.read: {len(win)} '{trace.WINDOW_RANGE}' ranges in {path}")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans, counting = defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if e["name"] == trace.COUNT_RANGE:
            counting[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        elif e["name"].startswith(PREFIX) and b > a:
            spans[e["name"]].append((e["tid"], a, b))
    steps = len(spans.get(STEP, ()))
    if not steps:
        return {}
    counting = {tid: trace._union(r) for tid, r in counting.items()}
    launch, skip = {}, set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch[corr] = (e["tid"], e["ts"])
            if any(a <= e["ts"] <= b for a, b in counting.get(e["tid"], ())):
                skip.add(corr)
    ops = []                                   # (start, end, is kernel)
    by_tid = defaultdict(list)                 # tid -> [(launch ts, index in ops)]
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in trace.DEVICE_CATS or corr in skip:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1)
        if t > s:
            if corr in launch:
                tid, ts = launch[corr]
                by_tid[tid].append((ts, len(ops)))
            ops.append((s, t, e["cat"] == "kernel"))
    for v in by_tid.values():
        v.sort()
    busy = trace._union((s, t) for s, t, _ in ops)
    idle = [[a[1], b[0]] for a, b in zip([[w0, w0]] + busy, busy + [[w1, w1]]) if b[0] > a[1]]

    def launched(ranges):
        """Indices of the operations launched inside ``ranges`` (disjoint)."""
        got = []
        for tid, a, b in ranges:
            v = by_tid.get(tid, [])
            got += [i for _, i in v[bisect.bisect_left(v, (a, -1)):
                                    bisect.bisect_right(v, (b, len(ops)))]]
        return got

    out = {name: _stats([ops[i] for i in launched(r)], r, idle, counting, steps)
           for name, r in spans.items()}
    sections = [r for name, rs in spans.items() if top_level(name) for r in rs]
    inside = set(launched(sections))
    host_tid = spans[STEP][0][0]
    edges = [w0] + [x for m in trace._union((a, b) for _, a, b in sections) for x in m] + [w1]
    gaps = [(host_tid, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    out[OUTSIDE] = _stats([op for i, op in enumerate(ops) if i not in inside], gaps, idle,
                          counting, steps)
    return out


def layers(secs: dict) -> dict:
    """``<layer>_busy_ms``, ``<layer>_idle_ms`` and ``<layer>_launches`` of
    each of :data:`LAYERS` from :func:`read`'s spans; {} without them."""
    if not secs:
        return {}
    return {f"{layer}_{k}": sum(secs.get(n, {}).get(k, 0.0) for n in names)
            for layer, names in LAYERS.items()
            for k in ("busy_ms", "idle_ms", "launches")}


def totals(secs: dict) -> dict:
    """The top-level spans' and ``outside``'s numbers summed."""
    parts = [v for n, v in secs.items() if top_level(n) or n == OUTSIDE]
    return {k: sum(v[k] for v in parts) for k in ("host_ms", "busy_ms", "idle_ms", "launches")}


def profiled(model, box: list, cadence: int, seconds: float, sync, path: str, device):
    """Whole cadences of ``model`` from the state in ``box`` for ``seconds``
    under the profiler, inside ``bench::window`` as the traced run's
    profiled phase; the trace exported to ``path``.  Returns the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .window import run_window

    cuda = [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else []
    acts = [ProfilerActivity.CPU] + cuda
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_RANGE):
            win = run_window(model, box, cadence, seconds, sync)
    prof.export_chrome_trace(path)
    box.append(win.state)
    return win


def phase(path: str, win) -> dict:
    """One profiled phase's line: its ms/step, the trace's idle share and
    launches, the spans and their sums."""
    got = trace.read_trace(path)
    secs = read(path)
    steps = win.steps
    return {"steps": steps, "ms_per_step": 1e3 * win.seconds / steps,
            "device_idle": 100.0 * (1.0 - got["busy_s"] / got["window_s"]),
            "launches_per_step": got["launches"] / steps,
            "window_ms": 1e3 * got["window_s"] / steps, "busy_ms": 1e3 * got["busy_s"] / steps,
            "idle_ms": 1e3 * (got["window_s"] - got["busy_s"]) / steps,
            "sums": totals(secs) if secs else None, "layers": layers(secs), "sections": secs}


def main(argv=None) -> int:
    import argparse
    import os
    import subprocess
    import sys
    import types

    import torch

    from . import cell as cellrun
    from . import spec
    from .window import cadence_of, warm_up

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=cellrun.PROFILE_SECONDS)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sections: no CUDA device", file=sys.stderr)
        return 3
    from wrf_partmc_tpu_torch.ops import _cuda
    from wrf_partmc_tpu_torch.utils import timing

    cell = spec.find_cell(args.workload)
    device = torch.device("cuda")
    sync = cellrun.syncer(device)
    _cuda.lib()
    model, state = spec.builder(cell.config["name"]).build(cell.config, cell.traffic,
                                                           args.seed, device)
    box = [state]
    del state
    cadence = cadence_of(model.cfg)
    warm_up(model, box, cadence)
    sync()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__,
                      "workload": cell.name, "seed": args.seed}), flush=True)
    path = str(spec.ROOT / "build" / "benchmark" / f"sections.{cell.name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    on = timing._profiler
    off = types.SimpleNamespace(_is_profiler_enabled=False)
    for i in range(2 * args.pairs):
        spans = i % 4 in (0, 3)                # on, off, off, on, ...
        timing._profiler = on if spans else off
        try:
            win = profiled(model, box, cadence, args.seconds, sync, path, device)
        finally:
            timing._profiler = on
        print(json.dumps({"spans": spans, **phase(path, win)}), flush=True)
        del win
        os.remove(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
