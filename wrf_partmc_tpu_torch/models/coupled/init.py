"""Coupled-model initial populations (port of ``populate_from_number_field``
and ``populate_from_dist`` of ``wrf_partmc_tpu/models/coupled/init.py``)."""

from __future__ import annotations

import torch

from ...config import Config
from ...grid import Grid
from ..partmc.aero_data import AeroData, diam_to_vol
from ..partmc.aero_state import AeroState, add_particles, fill_fresh, zero_state
from ..partmc.dist import AeroDist, sample_particles


def populate_from_number_field(aero_data: AeroData, cfg: Config, grid: Grid,
                               number_conc, key=None, n_per_cell: int | None = None,
                               diam: float = 1e-7, spec: str = "SO4",
                               w_class: int = 0, source: int = 0) -> AeroState:
    """Monodisperse population whose per-cell represented number matches the
    Eulerian field ``number_conc`` [nz, ny, nx] [# m-3], so particles and
    the NUM_CONC tracer start identical.  ``key`` is unused (the population
    is deterministic); it is kept for the reference's signature.  A cell
    where the field is 0 gets dead slots."""
    if n_per_cell is None:
        n_per_cell = cfg.partmc.num_particles
    cell_shape = (grid.nz, grid.ny, grid.nx)
    dev = grid.dz.device
    st = zero_state(aero_data, cfg.partmc.max_particles, cell_shape, device=dev)
    total = number_conc * grid.cell_volume.reshape(-1, 1, 1)
    E = n_per_cell
    num = (total / E)[..., None].expand(*cell_shape, E).to(torch.float32)
    pvol = diam_to_vol(torch.tensor(diam, dtype=torch.float32, device=dev))
    vol = torch.zeros((*cell_shape, aero_data.n_spec, E), dtype=torch.float32, device=dev)
    vol[..., aero_data.spec_by_name(spec), :] = torch.where(num > 0, pvol, 0.0)
    src = torch.full((*cell_shape, E), source, dtype=torch.int32, device=dev)
    wcl = torch.full((*cell_shape, E), w_class, dtype=torch.int32, device=dev)
    return add_particles(st, vol, num, src, wcl)


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
