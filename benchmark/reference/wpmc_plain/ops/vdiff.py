"""Implicit vertical diffusion of Eulerian fields.

Port of ``wrf_partmc_tpu/ops/vdiff.py``: backward-Euler column solve
(I - dt D) f^{n+1} = f^n with zero-flux ends, one tridiagonal system per
column.  The six fields share one set of coefficients, so they go through
``ops.tridiag.solve_fields`` together: one launch of kernel K1 on CUDA,
each field read in its own layout ([nz, ny, nx] or [L, nz, ny, nx]) with
no transpose.  The solves are column-local: on a rank's block the
coefficients and fields are the block's ``[nz, ny_l, nx_l]`` columns.
"""

from __future__ import annotations

import dataclasses

import torch

from ..grid import Grid
from .tridiag import solve_fields


def vdiff_coeffs(kv_face, grid: Grid, rho_b, dt):
    """Tridiagonal coefficients (dl, d, du), each [nz, ny, nx], from the
    face diffusivity kv_face [nz+1, ny, nx]."""
    dz = grid.dz
    dzf = grid.z_half[1:] - grid.z_half[:-1]
    k_int = kv_face[1:-1]
    rho_f = 0.5 * (rho_b[1:] + rho_b[:-1])
    flux = (rho_f / dzf)[:, None, None] * k_int
    cu = dt * flux / (rho_b[:-1] * dz[:-1])[:, None, None]
    cd = dt * flux / (rho_b[1:] * dz[1:])[:, None, None]
    zrow = torch.zeros_like(k_int[:1])
    du = -torch.cat([cu, zrow], dim=0)
    dl = -torch.cat([zrow, cd], dim=0)
    d = 1.0 - du - dl
    return dl, d, du


def diffuse_column(f, dl, d, du):
    """Apply the implicit solve to one field f, [..., nz, ny, nx] with any
    leading axes, against [nz, ny, nx] coefficients."""
    if f.dim() <= 4:
        return solve_fields(dl, d, du, [f])[0]
    return solve_fields(dl, d, du, [f.reshape(-1, *f.shape[-3:])])[0].reshape(f.shape)


FIELDS = ("u", "v", "theta_p", "moist", "chem", "tke")


def vertical_diffusion_state(dyn, kv_face, grid: Grid, rho_b, dt):
    """Mix u, v, theta', moisture, chem and TKE down each column."""
    dl, d, du = vdiff_coeffs(kv_face, grid, rho_b, dt)
    out = solve_fields(dl, d, du, [getattr(dyn, k) for k in FIELDS])
    return dataclasses.replace(dyn, **dict(zip(FIELDS, out)))
