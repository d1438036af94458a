"""particles_launches: the kernels launched inside the program's particle
spans (``wpmc.emission``, ``.transport``, ``.inflow``, ``.deposition``,
``.rebalance``), per step of the profiled phase (``sections.layers``;
launches/step)."""

from benchmark import sections


def read(run):
    return sections.layers(run.sections).get("particles_launches")
