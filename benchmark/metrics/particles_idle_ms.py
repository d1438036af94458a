"""particles_idle_ms: the device's idle time while the host was inside the
program's particle spans (``wpmc.emission``, ``.transport``,
``.inflow``, ``.deposition``, ``.rebalance``), per step of the profiled
phase (``sections.layers``; ms/step)."""

from benchmark import sections


def read(run):
    return sections.layers(run.sections).get("particles_idle_ms")
