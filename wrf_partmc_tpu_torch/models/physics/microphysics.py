"""Bulk-microphysics helpers shared by the Morrison scheme.

Port of ``sat_mixing_ratio_ice`` and ``_sediment`` of
``wrf_partmc_tpu/models/physics/microphysics.py``.  The Kessler and WSM5
steps of that module (mp_physics 1 and 2) are not ported.
"""

from __future__ import annotations

import torch

from ... import constants as c


def sat_mixing_ratio_ice(temp, pres):
    """Saturation mixing ratio over ice (Magnus-ice form)."""
    dt = temp - 273.16
    esi = 611.2 * torch.exp(21.8745584 * dt / torch.clamp(temp - 7.66, min=1.0))
    esi = torch.minimum(esi, 0.5 * pres)
    return c.EPS_VAP * esi / torch.clamp(pres - esi, min=1.0)


def _sediment(q, rho, vt, dz, dt):
    """Upwind downward sedimentation of rho*q with face speed vt [nz, ...];
    dz: [nz] column or [nz, ny, nx] field."""
    flux = rho * q * vt
    rdz = 1.0 / dz
    if rdz.dim() == 1:
        rdz = rdz.reshape(-1, 1, 1)
    flux_in = torch.cat([flux[1:], torch.zeros_like(flux[:1])], dim=0)
    return torch.clamp(q + dt * (flux_in - flux) * rdz / rho, min=0.0)
