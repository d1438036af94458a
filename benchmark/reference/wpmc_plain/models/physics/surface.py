"""Surface layer (Monin-Obukhov similarity) and the YSU-class PBL.

Port of ``wrf_partmc_tpu/models/physics/surface.py``: Businger-Dyer
stability functions, the surface-layer solve (five fixed-point iterations
for 1/L), the bulk-Richardson PBL height and the YSU eddy diffusivity at w
levels with its local free-atmosphere branch (``bl_physics=1``).  Fields
are [ny, nx] at the surface and [nz(+1), ny, nx] in the column.
"""

from __future__ import annotations

import math

import torch

from ... import constants as c


def psi_m(zeta):
    """Businger-Dyer momentum stability function psi_m(z/L)."""
    zeta = torch.clamp(zeta, -10.0, 10.0)
    x = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** 0.25
    unstable = (2.0 * torch.log(0.5 * (1.0 + x))
                + torch.log(0.5 * (1.0 + x * x))
                - 2.0 * torch.arctan(x) + 0.5 * math.pi)
    stable = -5.0 * torch.clamp(zeta, min=0.0)
    return torch.where(zeta < 0.0, unstable, stable)


def psi_h(zeta):
    """Businger-Dyer heat stability function psi_h(z/L)."""
    zeta = torch.clamp(zeta, -10.0, 10.0)
    y = torch.sqrt(1.0 - 16.0 * torch.clamp(zeta, max=0.0))
    unstable = 2.0 * torch.log(0.5 * (1.0 + y))
    stable = -5.0 * torch.clamp(zeta, min=0.0)
    return torch.where(zeta < 0.0, unstable, stable)


def surface_layer(u1, v1, th1, thsfc, z1, z0=0.1, z0t=None, n_iter: int = 5):
    """Monin-Obukhov surface-layer solve.  u1/v1/th1: first-level wind and
    potential temperature [ny, nx]; thsfc: skin potential temperature; z1:
    first-level height [m].  Returns dict(ustar, thstar, rmol (1/L),
    hfx_kin, ra (scalar aerodynamic resistance))."""
    if z0t is None:
        z0t = z0 * 0.1
    spd = torch.clamp(torch.sqrt(u1 * u1 + v1 * v1), min=0.1)
    dth = th1 - thsfc
    ln_m = torch.log(z1 / z0)
    ln_h = torch.log(z1 / z0t)

    rmol = torch.zeros_like(spd)                  # 1/L, start neutral
    ustar = c.KARMAN * spd / ln_m
    thstar = torch.zeros_like(spd)
    for _ in range(n_iter):
        zeta1 = torch.clamp(z1 * rmol, -10.0, 2.0)
        zeta0 = torch.clamp(z0 * rmol, -10.0, 2.0)
        zeta0t = torch.clamp(z0t * rmol, -10.0, 2.0)
        ustar = c.KARMAN * spd / torch.clamp(ln_m - psi_m(zeta1) + psi_m(zeta0), min=1.0)
        ustar = torch.clamp(ustar, min=0.01)
        thstar = c.KARMAN * dth / torch.clamp(ln_h - psi_h(zeta1) + psi_h(zeta0t),
                                              min=1.0)
        th_mean = 0.5 * (th1 + thsfc)
        L_inv = c.KARMAN * c.GRAV * thstar / (ustar * ustar
                                              * torch.clamp(th_mean, min=200.0))
        rmol = torch.clamp(L_inv, -0.5, 0.5)

    zeta1 = torch.clamp(z1 * rmol, -10.0, 2.0)
    zeta0t = torch.clamp(z0t * rmol, -10.0, 2.0)
    ra = (ln_h - psi_h(zeta1) + psi_h(zeta0t)) / (c.KARMAN * ustar)
    return dict(ustar=ustar, thstar=thstar, rmol=rmol,
                hfx_kin=-ustar * thstar, ra=torch.clamp(ra, min=1.0))


def pbl_height(theta, z_half, th_sfc_excess=0.5, u=None, v=None,
               rib_crit=0.25):
    """PBL height [ny, nx]: the first level whose bulk Richardson number
    g z (thv - thv_s) / (thv_s U^2) exceeds ``rib_crit`` (with winds), or
    whose theta exceeds the surface's by ``th_sfc_excess`` (without)."""
    zc = z_half.reshape(-1, 1, 1)
    if u is not None and v is not None:
        thv_s = theta[0] + th_sfc_excess
        spd2 = torch.clamp(u * u + v * v, min=0.25)
        rib = c.GRAV * zc * (theta - thv_s[None]) / (thv_s[None] * spd2)
        above = rib > rib_crit
    else:
        above = theta > (theta[0] + th_sfc_excess)[None]
    h = torch.amin(torch.where(above, zc, 1e9), dim=0)
    return torch.clamp(torch.maximum(h, z_half[0] * 2.0), max=5000.0)


def _phi_m(zeta):
    return torch.where(zeta < 0.0,
                       (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** -0.25,
                       1.0 + 5.0 * torch.clamp(zeta, min=0.0))


def _phi_h(zeta):
    return torch.where(zeta < 0.0,
                       (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** -0.5,
                       1.0 + 5.0 * torch.clamp(zeta, min=0.0))


def ysu_exch_h(grid, ustar, rmol, h_pbl, z_full=None, hfx_kin=None,
               theta=None, u=None, v=None):
    """YSU eddy diffusivity for heat and scalars at w levels
    [nz+1, ny, nx]: K_m = kappa w_s z (1 - z/h)^2, K_h = K_m / Pr, with the
    convective velocity scale under unstable conditions and u*/phi_m
    otherwise; above the PBL the local Ri-dependent mixing-length K when
    ``theta``/``u``/``v`` (half levels) are given."""
    z = (z_full if z_full is not None else grid.z_full).reshape(-1, 1, 1)
    h = torch.clamp(h_pbl[None], min=1.0)
    frac = torch.clamp(z / h, 0.0, 1.0)
    unstable = rmol[None] < 0.0

    if hfx_kin is not None:
        wstar3 = torch.clamp(c.GRAV / 300.0 * hfx_kin[None] * h, min=0.0)
    else:
        wstar3 = torch.where(unstable,
                             ustar[None] ** 3 * h * torch.abs(rmol[None]) / c.KARMAN,
                             0.0)
    ws_unst = (ustar[None] ** 3 + 7.0 * c.KARMAN * wstar3 * frac) ** (1.0 / 3.0)
    zeta = torch.clamp(z * rmol[None], -10.0, 2.0)
    ws_stab = ustar[None] / _phi_m(zeta)
    ws = torch.where(unstable, ws_unst, ws_stab)

    zeta_sl = torch.clamp(0.1 * h_pbl * rmol, -10.0, 2.0)[None]
    pr = _phi_h(zeta_sl) / _phi_m(zeta_sl) + 0.68 * c.KARMAN
    k_pbl = c.KARMAN * ws * z * (1.0 - frac) ** 2 / torch.clamp(pr, min=0.25)

    k = k_pbl
    if theta is not None and u is not None and v is not None:
        # free-atmosphere local K at interior w faces: l^2 S sqrt(max(1 -
        # Ri/0.25, 0)), l = min(kappa z, 150 m)
        zh = grid.z_half.reshape(-1, 1, 1)
        dzh = torch.clamp(zh[1:] - zh[:-1], min=1.0)
        dthdz = (theta[1:] - theta[:-1]) / dzh
        dudz = (u[1:] - u[:-1]) / dzh
        dvdz = (v[1:] - v[:-1]) / dzh
        s2 = torch.clamp(dudz ** 2 + dvdz ** 2, min=1e-8)
        th_m = 0.5 * (theta[1:] + theta[:-1])
        ri = c.GRAV / torch.clamp(th_m, min=200.0) * dthdz / s2
        lmix = torch.clamp(c.KARMAN * z[1:-1], max=150.0)
        k_loc = lmix ** 2 * torch.sqrt(s2) * torch.sqrt(
            torch.clamp(1.0 - ri / 0.25, 0.0, 1.0))
        zrow = torch.zeros_like(k_loc[:1])
        k_free = torch.cat([zrow, k_loc, zrow], dim=0)
        k = torch.where(frac >= 1.0, k_free, k_pbl)

    return torch.clamp(torch.clamp(k, min=0.1), 0.0, 2000.0).float()
