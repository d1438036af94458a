"""A cell at a size a CPU test run holds: its configuration's file with a
few cells and a few particles a cell."""

import dataclasses

from benchmark import spec

SIZES = {"em_uniform": dict(nx=6, ny=6, nz=4)}


def tiny_cell(name: str, bench=None) -> spec.Cell:
    cell = spec.find_cell(name, bench)
    traffic = dict(cell.traffic, particles_per_cell=6, slots_per_cell=12)
    return dataclasses.replace(cell, config=dict(cell.config, **SIZES[cell.config["name"]]),
                               traffic=traffic)
