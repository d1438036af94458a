"""dycore_busy_ms: the device's busy time in the program's dycore spans
(``wpmc.solve_step``, ``wpmc.vertical_diffusion``): the union of the
operations launched inside them, per step of the profiled phase
(``sections.layers``; ms/step)."""

from benchmark import sections


def read(run):
    return sections.layers(run.sections).get("dycore_busy_ms")
