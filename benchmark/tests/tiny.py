"""A cell at a size a CPU test run holds: its configuration's file with
the file's own ``"tiny"`` sizes and a few particles a cell."""

import dataclasses

from benchmark import spec


def tiny_cell(name: str, bench=None, root=spec.ROOT) -> spec.Cell:
    cell = spec.find_cell(name, bench, root)
    traffic = dict(cell.traffic, particles_per_cell=6, slots_per_cell=12)
    return dataclasses.replace(cell, config=dict(cell.config, **cell.config["tiny"]),
                               traffic=traffic)
