"""One run of one cell on this process's card.

Stages: load the kernels (``ops._cuda.lib()``, timed), build the cell's
configuration from the seed (timed, synchronised), warm up one cadence
and the step after it, reset the memory peak, then the window.  With
``trace`` 0 the window is whole cadences until ``seconds`` have passed.
With ``trace`` 1 it is two phases of whole cadences: a profiled one of at
least ``PROFILE_SECONDS`` (the device trace, each kernel call's bound),
then one with synchronised spans around the sections the metrics name,
until ``seconds`` have passed in all.  The state passes from stage to
stage in a one-element list, so that no stage keeps a state the program
has left behind and the memory peak is the program's.  After the window
the memory peak is read, the program is freed, and the configuration's
plain reference judges the window's last step (``compare``).  The metrics
are read by the cell's readers (``metrics/<name>.py``) from a
:class:`Run`: a traced run's program spans (``sections.read`` of the
profiled phase) and, for the counters the readers name (``COUNTERS``),
each counter's change from the window's start to its end, both copies
taken outside the timed steps.
"""

from __future__ import annotations

import gc
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from . import compare, sections, spec, trace
from .window import cadence_of, run_window, warm_up

PROFILE_SECONDS = 2.0
FORBIDDEN = ("jax", "jaxlib", "flax", "wrf_partmc_tpu")


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    cell: spec.Cell
    traced: bool
    setup_s: float = 0.0
    build_s: float = 0.0
    kernel_load_s: float = 0.0
    steps: int = 0                 # steps timed (both phases of a traced run)
    window_s: float = 0.0
    peak_bytes: int = 0
    spans: dict = field(default_factory=dict)      # site -> seconds (span phase)
    span_steps: int = 0
    trace: dict | None = None                       # trace.read_trace of the profiled phase
    trace_steps: int = 0
    kernel_bounds: list = field(default_factory=list)   # [(kernel, bound ms)]
    sections: dict = field(default_factory=dict)   # sections.read of the profiled phase
    counters: dict = field(default_factory=dict)   # site -> {name: change over the window}


def forbidden_modules() -> list:
    """Top-level names of ``sys.modules`` that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def syncer(device):
    """A function that waits for ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def power_limit(device) -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    lines = smi.stdout.strip().splitlines()
    idx = torch.device(device).index or 0
    return lines[idx].strip() if smi.returncode == 0 and len(lines) > idx else "unread"


def judge(cell: spec.Cell, seed: int, device, prog_prev, prog_out, fp_prog,
          control: bool = False):
    """The comparison's numbers: the configuration's reference builds the
    start from the seed and follows the program's last step from the state
    it started from.  With ``control``, also the control's numbers: the
    reference in bfloat16 (its start, the step's input and its output
    rounded) in the program's place.  Returns the readings, or (program's,
    control's)."""
    from .reference.state import adopt

    model, s0 = spec.builder(cell.config["name"]).build(cell.config, cell.traffic, seed,
                                                        device, root=cell.reference)
    fp_ref = compare.fingerprint(s0)
    fp_ctrl = compare.fingerprint(compare.to_bfloat16(s0)) if control else None
    del s0
    ref_out = model(adopt(prog_prev, device, cell.reference))
    got = compare.readings(prog_out, ref_out, fp_prog, fp_ref)
    if not all(math.isfinite(v) for v in got.values()):
        print("not finite: the step's input "
              f"{compare.nonfinite(prog_prev)}, the program's output "
              f"{compare.nonfinite(prog_out)}, the reference's "
              f"{compare.nonfinite(ref_out)}", file=sys.stderr, flush=True)
    if not control:
        return got
    ctrl_out = compare.to_bfloat16(model(compare.to_bfloat16(
        adopt(prog_prev, device, cell.reference))))
    return got, compare.readings(ctrl_out, ref_out, fp_ctrl, fp_ref)


def free_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """One run: ``run`` (:class:`Run`), the comparison's ``readings``, each
    metric's value, the card's name and, traced, its power limit (for the
    result line, :func:`result`)."""
    device = torch.device(device)
    sync = syncer(device)
    run = Run(cell=cell, traced=traced)
    cuda = device.type == "cuda"
    if cuda:
        from wrf_partmc_tpu_torch.ops import _cuda
        t0 = time.perf_counter()
        _cuda.lib()
        run.kernel_load_s = time.perf_counter() - t0

    sync()
    t0 = time.perf_counter()
    model, state = spec.builder(cell.config["name"]).build(cell.config, cell.traffic, seed,
                                                           device)
    sync()
    run.build_s = time.perf_counter() - t0
    fp_prog = compare.fingerprint(state)
    box = [state]
    del state
    cadence = cadence_of(model.cfg)
    readers = {m["name"]: spec.reader(m["name"])
               for m in (cell.per_layer if traced else cell.end_to_end)}
    warm_up(model, box, cadence)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.time() - t_start
    counted = [s for r in readers.values() for s in getattr(r, "COUNTERS", ())]
    counts = trace.read_counters(counted)
    if traced:
        win, trace_path = _traced_window(run, model, box, cadence, seconds, device, sync,
                                          readers)
    else:
        win = run_window(model, box, cadence, seconds, sync)
        run.steps, run.window_s = win.steps, win.seconds
    run.counters = trace.counter_change(counts, trace.read_counters(counted))
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    if traced:
        run.trace = trace.read_trace(trace_path)
        run.sections = sections.read(trace_path)
        os.remove(trace_path)
    prog_prev, prog_out = win.prev, win.state
    del model, win
    free_device(device)
    readings = judge(cell, seed, device, prog_prev, prog_out, fp_prog)
    return {"run": run, "readings": readings,
            "values": {name: r.read(run) for name, r in readers.items()},
            "device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "power_limit": power_limit(device) if cuda and traced else None}


def _traced_window(run: Run, model, box: list, cadence: int, seconds: float, device,
                   sync, readers: dict):
    """The profiled phase, then the span phase (run.* filled in), the
    state handed from one to the other in ``box``.  Returns the span
    phase's window and the chrome trace's path."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    path = str(spec.ROOT / "build" / "benchmark" / f"trace.{run.cell.name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    calls = trace.KernelCalls()
    with profile(activities=acts) as prof:
        with calls, record_function(trace.WINDOW_RANGE):
            win_a = run_window(model, box, cadence, PROFILE_SECONDS, sync)
    prof.export_chrome_trace(path)
    del prof
    run.trace_steps = win_a.steps
    run.kernel_bounds = calls.bounds()
    box.append(win_a.state)
    del win_a
    sites = [s for r in readers.values() for s in getattr(r, "SITES", ())]
    with trace.Spans(sites, sync) as spans:
        win_b = run_window(model, box, cadence, max(seconds - PROFILE_SECONDS, 0.0), sync)
    run.spans = dict(spans.seconds)
    run.span_steps = win_b.steps
    run.steps = run.trace_steps + win_b.steps
    return win_b, path


def _number(v):
    return v if v is None or math.isfinite(v) else "inf"


def result(part: dict, cell: spec.Cell) -> tuple:
    """(the result line's object, the compared numbers' lines) from
    :func:`run_cell`'s part."""
    run = part["run"]
    missing = sorted(set(cell.limits) - set(part["readings"]))
    if missing:
        raise spec.SpecError(f"cell {cell.name!r}: limits for numbers the comparison does "
                             f"not read: {missing}")
    readings = {k: part["readings"][k] for k in cell.limits}
    compared = {k: {"value": _number(v), "limit": cell.limits[k]} for k, v in readings.items()}
    failed = sum(1 for k, v in readings.items() if not v <= cell.limits[k])
    units = {m["name"]: m["unit"] for m in (*cell.end_to_end, *cell.per_layer)}
    metrics = {name: {"value": v, "unit": units[name]}
               for name, v in part["values"].items() if v is not None}
    device = {"platform": "gpu" if part["device"] != "cpu" else "cpu", "kind": part["device"],
              "count": 1, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": failed == 0, "attempted": run.steps, "failed": failed,
           "metrics": metrics, "device": device}
    if run.traced:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        device["power_limit"] = part["power_limit"]
        out["breakdown"] = {"device_ops": [list(x) for x in run.trace["device_ops"]],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["compared"] = compared
    lines = [f"compared {k}: {v['value']} (limit {v['limit']})" for k, v in compared.items()]
    return out, lines
