"""particles_busy_ms: the device's busy time in the program's particle
spans (``wpmc.emission``, ``.transport``, ``.inflow``, ``.deposition``,
``.rebalance``): the union of the operations launched inside them, per
step of the profiled phase (``sections.layers``; ms/step)."""

from benchmark import sections


def read(run):
    return sections.layers(run.sections).get("particles_busy_ms")
