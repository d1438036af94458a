"""Coupled-model initial population (port of ``populate_from_dist`` of
``wrf_partmc_tpu/models/coupled/init.py``)."""

from __future__ import annotations

from ...config import Config
from ...grid import Grid
from ..partmc.aero_data import AeroData
from ..partmc.aero_state import AeroState, fill_fresh
from ..partmc.dist import AeroDist, sample_particles


def populate_from_dist(aero_data: AeroData, cfg: Config, grid: Grid,
                       dist: AeroDist, key, n_per_cell: int | None = None) -> AeroState:
    """Sample the mode set into every cell; the E sampled entries fill slots
    0..E-1 directly (``fill_fresh``, no placement kernel)."""
    if n_per_cell is None:
        n_per_cell = cfg.partmc.num_particles
    cell_shape = (grid.nz, grid.ny, grid.nx)
    V = grid.cell_volume.reshape(-1, 1, 1).expand(cell_shape)
    vol, num, src, wcl = sample_particles(key, dist, aero_data, n_per_cell,
                                          V, cell_shape)
    return fill_fresh(aero_data, cfg.partmc.max_particles, vol, num, src, wcl)
