"""dycore_idle_ms: the device's idle time while the host was inside the
program's dycore spans (``wpmc.solve_step``,
``wpmc.vertical_diffusion``), per step of the profiled phase
(``sections.layers``; ms/step)."""

from benchmark import sections


def read(run):
    return sections.layers(run.sections).get("dycore_idle_ms")
