"""The coupled step's named spans (``utils.timing.span``).

Under ``torch.profiler`` a small em_uniform step shows each of its
sections once a step, in the order it runs them, nested under
``wpmc.step``, and the transport's blocks under ``wpmc.transport``; with
no profiler recording ``span`` never makes a ``record_function``; the
step's output is bit-equal either way.  ``SectionTimers`` sections appear
as spans too.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wrf_partmc_tpu_torch.entry import build
from wrf_partmc_tpu_torch.utils import timing
from wrf_partmc_tpu_torch.utils.timing import SectionTimers
from wrf_partmc_tpu_torch.utils.tree import tensor_leaves

SECTIONS = ("wpmc.to_wrf", "wpmc.solve_step", "wpmc.bdy", "wpmc.pbl",
            "wpmc.vertical_diffusion", "wpmc.from_wrf", "wpmc.emission", "wpmc.optics",
            "wpmc.macro_step", "wpmc.cumulus", "wpmc.radiation", "wpmc.transport",
            "wpmc.inflow", "wpmc.deposition", "wpmc.rebalance", "wpmc.finish")
TRANSPORT = tuple(f"wpmc.transport.{b}"
                  for b in ("probs", "sample", "ranks", "t1", "thin", "t2", "unpack"))


@pytest.fixture(scope="module")
def model_state():
    return build(nx=6, ny=6, nz=4, n_part=4, cap=8, device="cpu")


def _ranges(prof, tmp_path, prefix="wpmc."):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith(prefix))


def _inside(outer, ranges):
    return [r for r in ranges if outer[0] <= r[0] and r[1] <= outer[1] and r is not outer]


def _equal(a, b):
    la, lb = tensor_leaves(a, "s"), tensor_leaves(b, "s")
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def test_sections_nested_once_a_step(model_state, tmp_path):
    model, s0 = model_state
    s1 = model(s0)                                  # the first step's lazy set-up
    plain = model(s1)
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing._profiler._is_profiler_enabled
        assert timing.span("wpmc.x") is not timing.span("wpmc.y")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = model(s1)
        model(traced)
    assert _equal(traced, plain)
    ranges = _ranges(prof, tmp_path)
    steps = [r for r in ranges if r[2] == "wpmc.step"]
    assert len(steps) == 2 and steps[0][1] <= steps[1][0]
    for step in steps:
        inner = _inside(step, ranges)
        top = [r for r in inner if r[2].count(".") == 1]
        assert tuple(r[2] for r in top) == SECTIONS
        assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
        tr = next(r for r in top if r[2] == "wpmc.transport")
        assert tuple(r[2] for r in _inside(tr, ranges)) == TRANSPORT
        assert tuple(r[2] for r in inner if r[2].count(".") == 2) == TRANSPORT


def test_no_record_function_without_profiler(model_state, monkeypatch):
    model, s0 = model_state

    def refuse(*_a, **_k):
        raise AssertionError("record_function with no profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not timing._profiler._is_profiler_enabled
    assert timing.span("wpmc.a") is timing.span("wpmc.b")
    model(s0)
    t = SectionTimers()
    with t.section("a"):
        pass
    assert t.counts["a"] == 1


def test_section_timers_are_spans(tmp_path):
    calls = []
    t = SectionTimers(sync=lambda: calls.append(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.section("coupled_step"):
            with timing.span("wpmc.step"):
                pass
    ranges = _ranges(prof, tmp_path, prefix="")
    outer = next(r for r in ranges if r[2] == "coupled_step")
    assert [r[2] for r in _inside(outer, ranges)] == ["wpmc.step"]
    assert t.counts["coupled_step"] == 1 and calls == [1]
