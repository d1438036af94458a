"""``correct`` at a size a CPU run holds: true for the program, false for
the control (the reference in bfloat16 in the program's place) and for
each fault the cells can have, planted in the program under the harness:
a step that returns its state unchanged, half of the cells left out of
the step, and a value altered where the step produces it."""

import dataclasses
import time

import pytest
import torch

from benchmark import cell as C
from benchmark import spec
from benchmark.tests.tiny import tiny_cell
from benchmark.window import cadence_of, run_window, warm_up

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
DRIVER = "wrf_partmc_tpu_torch.models.coupled.driver"


def _run(name):
    cell = tiny_cell(name)
    obj, _ = C.result(C.run_cell(cell, 2**31 + 5, 0.0, False, "cpu", time.time()), cell)
    return obj


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    obj = _run(name)
    assert obj["correct"], obj["compared"]
    assert list(obj)[-1] == "compared" and obj["failed"] == 0


def _unchanged(step):
    def fault(cs, *a, **k):
        return dataclasses.replace(cs, step=cs.step + 1), {}
    return fault


def _half_left_out(step):
    def fault(cs, *a, **k):
        out, diag = step(cs, *a, **k)
        ny = cs.aero.num.shape[1]
        keep = torch.arange(ny).reshape(1, -1, 1) < ny // 2
        aero = dataclasses.replace(out.aero, **{
            f.name: torch.where(keep.reshape(keep.shape + (1,) * (getattr(out.aero, f.name).dim() - 3)),
                                getattr(out.aero, f.name), getattr(cs.aero, f.name))
            for f in dataclasses.fields(out.aero)})
        return dataclasses.replace(out, aero=aero), diag
    return fault


def _altered(step):
    def fault(cs, *a, **k):
        out, diag = step(cs, *a, **k)
        u = out.dyn.u.clone()
        u[0, 0, 0] += 0.5
        return dataclasses.replace(out, dyn=dataclasses.replace(out.dyn, u=u)), diag
    return fault


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_faults_are_not_correct(name, fault, monkeypatch):
    mod, _ = C.trace.resolve(f"{DRIVER}:coupled_step")
    monkeypatch.setattr(mod, "coupled_step", fault(mod.coupled_step))
    obj = _run(name)
    assert not obj["correct"] and obj["failed"] >= 1, obj["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The control at a size a test run holds; on the chip at the cell's
    size it is ``python -m benchmark.control``."""
    cell = tiny_cell(name)
    model, state = spec.builder(cell.config["name"]).build(cell.config, cell.traffic, 11, "cpu")
    fp = C.compare.fingerprint(state)
    cadence = cadence_of(model.cfg)
    box = [state]
    warm_up(model, box, cadence)
    win = run_window(model, box, cadence, 0.0)
    got, ctrl = C.judge(cell, 11, "cpu", win.prev, win.state, fp, control=True)
    assert all(got[k] <= v for k, v in cell.limits.items()), got
    assert any(ctrl[k] > v for k, v in cell.limits.items()), ctrl


@pytest.mark.parametrize("name", CELLS)
def test_reference_steps_the_state_in_its_own_classes(name):
    """The program's state handed to the configuration's reference is
    rebuilt in that reference's classes, every tensor a copy."""
    from benchmark.reference.state import MODULES, adopt

    cell = tiny_cell(name)
    _, state = spec.builder(cell.config["name"]).build(cell.config, cell.traffic, 13, "cpu")
    got = adopt(state, None, cell.reference)
    for obj, mine in ((got, state), (got.dyn, state.dyn), (got.aero, state.aero)):
        cls = type(obj)
        assert cls.__module__ == f"{cell.reference}.{MODULES[cls.__name__]}"
        assert cls is not type(mine) and cls.__name__ == type(mine).__name__
    assert got.aero.num.data_ptr() != state.aero.num.data_ptr()
    assert torch.equal(got.aero.num, state.aero.num)
