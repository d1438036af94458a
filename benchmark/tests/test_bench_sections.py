"""The program's spans read from a profiler trace: on made-up events, each
span's busy, idle and launches exactly, the split of the window; on the
CPU, a tiny cell's profiled phase."""

import json

import pytest
import torch

from benchmark import cell, sections, spec, trace
from benchmark.tests.tiny import tiny_cell
from benchmark.window import cadence_of, warm_up


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 2.0, corr=corr)


def _kernel(ts, dur, corr, cat="kernel"):
    return _ev(cat, "elementwise_kernel", ts, dur, tid=7, corr=corr)


EVENTS = [
    _ev("user_annotation", trace.WINDOW_RANGE, 1000.0, 1000.0),
    _launch(900.0, 8), _kernel(990.0, 20.0, 8),              # runs into the window: outside
    _launch(1050.0, 6), _kernel(1060.0, 30.0, 6),            # between steps: outside
    _ev("user_annotation", "wpmc.step", 1100.0, 700.0),
    _ev("user_annotation", "wpmc.solve_step", 1100.0, 200.0),
    _launch(1110.0, 1), _kernel(1150.0, 100.0, 1),
    _ev("user_annotation", "wpmc.transport", 1400.0, 300.0),
    _launch(1420.0, 3), _kernel(1500.0, 20.0, 3),
    _ev("user_annotation", "wpmc.transport.t1", 1450.0, 100.0),
    _launch(1460.0, 4), _kernel(1520.0, 80.0, 4),
    _ev("user_annotation", trace.COUNT_RANGE, 1530.0, 20.0),
    _launch(1535.0, 5), _kernel(1600.0, 50.0, 5),            # the harness's counting
    _launch(1750.0, 7), _kernel(1760.0, 30.0, 7, "gpu_memcpy"),   # in the step, no section
    _ev("cpu_op", "aten::add", 1750.0, 10.0),
    _ev("user_annotation", "other", 1900.0, 50.0),          # not the program's
    _ev("gpu_user_annotation", trace.WINDOW_RANGE, 1000.0, 1000.0, tid=7),
]


@pytest.fixture
def made_up(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return str(path)


def test_each_span_exactly(made_up):
    got = sections.read(made_up)
    ms = 1e-3
    assert set(got) == {"wpmc.step", "wpmc.solve_step", "wpmc.transport", "wpmc.transport.t1",
                        sections.OUTSIDE}
    want = {"wpmc.solve_step": (200, 100, 100, 1),
            "wpmc.transport": (300 - 20, 100, 200, 2),
            "wpmc.transport.t1": (100 - 20, 80, 50, 1),
            "wpmc.step": (700 - 20, 230, 470, 3),
            sections.OUTSIDE: (500, 70, 430, 2)}
    for name, (host, busy, idle, launches) in want.items():
        assert got[name] == pytest.approx({"host_ms": host * ms, "busy_ms": busy * ms,
                                           "idle_ms": idle * ms, "launches": launches}), name


def test_split_of_the_window(made_up):
    got, whole = sections.read(made_up), trace.read_trace(made_up)
    sums = sections.totals(got)
    assert sums["idle_ms"] == pytest.approx(1e3 * (whole["window_s"] - whole["busy_s"]))
    assert sums["busy_ms"] == pytest.approx(1e3 * whole["busy_s"])
    assert sums["launches"] == whole["launches"]
    assert sums["host_ms"] == pytest.approx(1e3 * whole["window_s"] - 20e-3)
    lay = sections.layers(got)
    assert lay["dycore_busy_ms"] == pytest.approx(0.1)
    assert lay["particles_launches"] == 2 and lay["particles_idle_ms"] == pytest.approx(0.2)


def test_no_program_spans(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [e for e in EVENTS
                                                if not e["name"].startswith("wpmc.")]}))
    assert sections.read(str(path)) == {} and sections.layers({}) == {}


def test_readers_unmoved_by_sections(made_up):
    """The span metrics read the layers of ``run.sections`` (None without
    spans); every other reader is unmoved by them."""
    bench = spec.load_benchmark()
    run = cell.Run(cell=spec.find_cell("em_uniform.p1000"), traced=True, setup_s=10.0,
                   build_s=1.0, kernel_load_s=0.5, steps=12, window_s=1.2, peak_bytes=2 ** 30,
                   spans={"wrf_partmc_tpu_torch.models.coupled.driver:solve_step": 0.1},
                   span_steps=4, trace=trace.read_trace(made_up), trace_steps=1,
                   kernel_bounds=[("K1", 1e-4)])
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    before = {n: spec.reader(n).read(run) for n in names}
    run.sections = sections.read(made_up)
    after = {n: spec.reader(n).read(run) for n in names}
    lay = sections.layers(run.sections)
    assert set(lay) <= set(names) and len(lay) == 6
    assert all(before[n] is None for n in lay)
    assert {n: after[n] for n in lay} == lay
    assert {n: v for n, v in after.items() if n not in lay} == {
        n: v for n, v in before.items() if n not in lay}


def test_tiny_cell_profiled(tmp_path):
    c = tiny_cell("em_uniform.p1000")
    model, state = spec.builder("em_uniform").build(c.config, c.traffic, 3000000017, "cpu")
    box = [state]
    del state
    cadence = cadence_of(model.cfg)
    warm_up(model, box, cadence)
    path = str(tmp_path / "t.json")
    win = sections.profiled(model, box, cadence, 0.0, cell.syncer("cpu"), path,
                            torch.device("cpu"))
    got = sections.read(path)
    assert win.steps == cadence and len(box) == 1
    assert {"wpmc.step", "wpmc.solve_step", "wpmc.transport", "wpmc.transport.t2",
            sections.OUTSIDE} <= set(got)
    assert got["wpmc.step"]["host_ms"] >= got["wpmc.transport"]["host_ms"] > 0.0
    assert sections.totals(got)["launches"] == 0
    line = sections.phase(path, win)
    assert line["sums"]["idle_ms"] == pytest.approx(line["idle_ms"])
