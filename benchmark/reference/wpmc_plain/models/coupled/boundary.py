"""Lateral boundary conditions for the coupled model.

Port of ``wrf_partmc_tpu/models/coupled/boundary.py``: on open axes, edge
cells whose face-normal wind blows into the domain take the scenario
background, for gases (``apply_gas_open_bc``) and for particles, whose
populations are replaced by a fresh background sample drawn on the
``STREAM_BC`` key (``resample_inflow_particles``).  Particles leaving the
domain are dropped by the transport (``transport.open_boundary_drop``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...config import Config
from ...grid import Grid
from ...ops.stencil import AXIS_X, AXIS_Y, on_grid, shift
from ..dycore.state import DycoreState
from ..partmc.aero_data import AeroData
from ..partmc.aero_state import AeroState
from ..partmc.dist import sample_particles
from ..partmc.scenario import Scenario


def edge_inflow_masks(dyn: DycoreState, grid: Grid, cfg: Config):
    """[nz, ny, nx] bool: edge cells whose face-normal wind blows into the
    domain (u at west faces, v at south faces), from the global indices of
    the cells; on a block ``grid``, the block's (the east and north faces
    of the last cells are the wrapped first faces, from the neighbouring
    rank through ``stencil.shift``)."""
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    NY, NX = grid.global_shape
    y0, x0 = grid.offsets
    dev = dyn.u.device
    ii = x0 + torch.arange(nx, device=dev).reshape(1, 1, nx)
    jj = y0 + torch.arange(ny, device=dev).reshape(1, ny, 1)
    m = torch.zeros((nz, ny, nx), dtype=torch.bool, device=dev)
    b = cfg.boundary
    with on_grid(grid):
        if not b.periodic_x:
            m = m | ((ii == 0) & (dyn.u > 0.0))
            m = m | ((ii == NX - 1) & (shift(dyn.u, 1, AXIS_X) < 0.0))
        if not b.periodic_y:
            m = m | ((jj == 0) & (dyn.v > 0.0))
            m = m | ((jj == NY - 1) & (shift(dyn.v, 1, AXIS_Y) < 0.0))
    return m


def apply_gas_open_bc(gas, dyn: DycoreState, scn: Scenario, grid: Grid, cfg: Config):
    """gas: [nz, ny, nx, G] ppb (on a block ``grid``, with ``dyn``, the
    rank's block); inflow edge cells take the background."""
    if cfg.boundary.periodic_x and cfg.boundary.periodic_y:
        return gas
    inflow = edge_inflow_masks(dyn, grid, cfg)
    return torch.where(inflow[..., None], scn.back_gas, gas)


def resample_inflow_particles(aero: AeroState, dyn: DycoreState,
                              scn: Scenario, aero_data: AeroData, grid: Grid,
                              cfg: Config, key, mesh=None) -> AeroState:
    """Replace the populations of inflow edge cells with a fresh background
    sample of ``num_particles`` entries (slots beyond them left dead).  As
    in the reference, the source-attribution and hysteresis fields of those
    cells are left as they were.  With ``mesh``, ``aero`` is this rank's
    block and it draws the block's slice of the global sample."""
    if cfg.boundary.periodic_x and cfg.boundary.periodic_y:
        return aero
    cell_shape = aero.cell_shape
    inflow = edge_inflow_masks(dyn, grid, cfg)
    block = mesh.draw_block(*grid.global_shape) if mesh is not None else None
    V = grid.cell_volume.reshape(-1, 1, 1).expand(cell_shape)
    n_bc = cfg.partmc.num_particles
    vol, num, src, wcl = sample_particles(key, scn.back_dist, aero_data, n_bc,
                                          V, cell_shape, block)
    pad = lambda a: F.pad(a, (0, aero.capacity - n_bc))
    m = inflow[..., None]
    pid = aero.next_id[..., None] + torch.arange(n_bc, dtype=torch.int32,
                                                 device=aero.num.device)
    return dataclasses.replace(
        aero,
        vol=torch.where(m[..., None, :], pad(vol), aero.vol),
        num=torch.where(m, pad(num), aero.num),
        source=torch.where(m, pad(src.to(torch.int32)), aero.source),
        w_class=torch.where(m, pad(wcl.to(torch.int32)), aero.w_class),
        pid=torch.where(m, pad(pid), aero.pid),
        t_create=torch.where(m, 0.0, aero.t_create),
        next_id=aero.next_id + torch.where(inflow, n_bc, 0).to(torch.int32))
