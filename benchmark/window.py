"""The measured window: whole cadences of the coupled step.

The cadence is the configuration's longest periodic process in steps: the
chemistry macro-step's ``round(partmc_chem_dt / dt)``, which the coupled
step runs when ``state.step % cadence == 0`` and one of its processes is
on, and one step where none is.  The warm-up runs steps 0 .. cadence (with
a macro-step, two of them: every shape the cell uses), so the window
starts at step cadence + 1 and each of its cadences ends with a
macro-step.  The window steps whole cadences until ``seconds`` have passed
at a cadence boundary, and ends there with a synchronise; its time over
all its steps is the step time.

The state goes in and out through a one-element list that the window
empties: a caller that still named the state it handed over would keep
one more state alive through every step, and the memory peak would count
it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class Window:
    state: object          # the state after the window's last step
    prev: object           # the state that step started from
    steps: int
    seconds: float         # from the synchronise before the first step to the one after the last


def cadence_of(cfg) -> int:
    """Steps between two chemistry macro-steps of a ``Config``; 1 when the
    configuration runs none (the rule of ``driver.coupled_step``)."""
    pc = cfg.partmc
    if not (pc.do_coagulation or pc.do_condensation or pc.do_nucleation or pc.do_mosaic):
        return 1
    return max(1, int(round(pc.partmc_chem_dt / cfg.dynamics.dt)))


def warm_up(step, box: list, cadence: int) -> None:
    """Steps 0 .. ``cadence`` (``cadence`` + 1 steps) from the state at
    step 0 in ``box``, which then holds the state after them."""
    state = box.pop()
    for _ in range(cadence + 1):
        state = step(state)
    box.append(state)


def run_window(step, box: list, cadence: int, seconds: float, sync=lambda: None,
               clock=time.perf_counter) -> Window:
    """Whole cadences of ``step`` from the state in ``box`` (which it
    empties) until ``seconds`` have passed at a cadence boundary.  ``sync``
    waits for the device.  Only the state a step starts from is kept beside
    its output, which the step holds anyway."""
    state = box.pop()
    sync()
    t0 = clock()
    steps = 0
    prev = None
    while True:
        for _ in range(cadence):
            prev = state
            state = step(prev)
            steps += 1
        if clock() - t0 >= seconds:
            break
    sync()
    return Window(state=state, prev=prev, steps=steps, seconds=clock() - t0)
