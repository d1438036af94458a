"""dycore_launches: the kernels launched inside the program's dycore spans
(``wpmc.solve_step``, ``wpmc.vertical_diffusion``), per step of the
profiled phase (``sections.layers``; launches/step)."""

from benchmark import sections


def read(run):
    return sections.layers(run.sections).get("dycore_launches")
