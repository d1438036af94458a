"""Boundary-layer K-profile closure (port of
``wrf_partmc_tpu/models/physics/pbl.py``)."""

from __future__ import annotations

import torch

from ... import constants as c
from ...grid import Grid


def k_profile_exch_h(grid: Grid, ustar, pbl_height):
    """exch_h at w levels [nz+1, ny, nx]: K = kappa u* z (1 - z/h)^2.
    ustar, pbl_height: scalars or [ny, nx]."""
    z = grid.z_full.reshape(-1, 1, 1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=z.device)
    us = f32(ustar)
    h = f32(pbl_height)
    frac = torch.clamp(z / torch.clamp(h, min=1.0), 0.0, 1.0)
    k = c.KARMAN * us * z * (1.0 - frac) ** 2
    return torch.clamp(k, min=0.0).expand(grid.nz + 1, grid.ny, grid.nx).contiguous()
