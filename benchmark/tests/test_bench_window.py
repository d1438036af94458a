"""The window: whole cadences, ended at the first cadence boundary after
the time, every step counted, the last step a macro-step; the cadence as
the coupled step schedules its macro-step; no state kept beside the
window's."""

import dataclasses
import gc
import weakref

import pytest

from benchmark.window import cadence_of, run_window, warm_up


class Clock:
    """A host clock that advances ``dt`` at every step."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        return self.t


@pytest.mark.parametrize("cadence,dt,seconds", [(6, 0.15, 5.0), (30, 0.08, 5.0),
                                                 (10, 0.6, 30.0), (10, 0.6, 0.0)])
def test_whole_cadences(cadence, dt, seconds):
    clock = Clock(dt)
    seen = []

    def step(s):
        seen.append(s)
        clock.t += dt
        return s + 1

    box = [0]
    warm_up(step, box, cadence)
    assert box == [cadence + 1]
    seen.clear()
    win = run_window(step, box, cadence, seconds, clock=clock)
    assert box == []
    assert win.steps % cadence == 0 and win.steps == len(seen)
    assert seen[-1] % cadence == 0                  # the last step runs the macro-step
    assert win.prev == seen[-1] and win.state == seen[-1] + 1
    assert win.seconds >= seconds
    assert win.seconds - cadence * dt < seconds or win.steps == cadence
    assert win.seconds == pytest.approx(win.steps * dt)


class State:
    """A state object that a step replaces."""

    def __init__(self, step):
        self.step = step


def test_no_state_kept_beside_the_window():
    """Once a step has replaced a state, nothing of the harness holds it:
    the memory peak counts the program's states alone."""
    alive = []

    def step(s):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        out = State(s.step + 1)
        refs.append(weakref.ref(out))
        return out

    first = State(0)
    refs = [weakref.ref(first)]
    box = [first]
    del first
    warm_up(step, box, 2)
    win = run_window(step, box, 2, 0.0)
    assert win.steps == 2
    assert max(alive) == 1               # only the step's input is alive while it steps


@dataclasses.dataclass
class _PC:
    partmc_chem_dt: float = 60.0
    do_coagulation: bool = False
    do_condensation: bool = False
    do_nucleation: bool = False
    do_mosaic: bool = False


@dataclasses.dataclass
class _Cfg:
    partmc: _PC
    dynamics: object = dataclasses.field(
        default_factory=lambda: type("D", (), {"dt": 10.0})())


@pytest.mark.parametrize("flags,cadence", [({}, 1), ({"do_coagulation": True}, 6),
                                           ({"do_mosaic": True}, 6),
                                           ({"do_condensation": True}, 6),
                                           ({"do_nucleation": True}, 6)])
def test_cadence(flags, cadence):
    assert cadence_of(_Cfg(_PC(**flags))) == cadence


def test_a_run_keeps_no_state_beside_the_program(monkeypatch):
    """Through a whole run on the CPU, each step starts with its input as
    the only state of the program alive: the harness holds no other."""
    import time

    from benchmark import cell as C
    from benchmark.tests.tiny import tiny_cell
    from wrf_partmc_tpu_torch.models.coupled import driver

    alive = []
    step = driver.coupled_step

    def counted(cs, *args, **kwargs):
        gc.collect()
        alive.append(sum(type(o) is driver.CoupledState for o in gc.get_objects()))
        return step(cs, *args, **kwargs)

    monkeypatch.setattr(driver, "coupled_step", counted)
    cell = tiny_cell("em_uniform.p1000")
    part = C.run_cell(cell, 5, 0.0, False, "cpu", time.time())
    assert part["run"].steps >= 1 and len(alive) >= 3
    assert max(alive) == 1, alive
