"""Mellor-Yamada-Janjic surface layer + level-2.5 TKE PBL (bl_physics=2).

Port of ``wrf_partmc_tpu/models/physics/myj.py``: Monin-Obukhov surface
layer with Paulson / Holtslag-de Bruin stability functions, the
quasi-equilibrium level-2.5 stability functions, a dissipation-implicit
prognostic q2 = 2 TKE at w levels, and the implicit vertical transport of
q2, one tridiagonal system per column through ``ops.tridiag.solve`` (kernel
K1 on CUDA).  Produces ``exch_h`` / ``ustar`` / ``rmol`` for the particle
vertical operator, vertical diffusion and deposition.
"""

from __future__ import annotations

import torch

from ... import constants as c
from ...ops.tridiag import solve as tridiag_solve

A1 = 0.92
A2 = 0.74
B1 = 16.6
B2 = 10.1
C1 = 0.08
S_Q = 0.2                  # TKE-transport coefficient K_q = l q S_q
Q2_MIN = 0.02              # TKE floor [m2 s-2]
L0_ALPHA = 0.1             # Blackadar asymptotic-length integral weight
L0_MIN, L0_MAX = 10.0, 500.0
GH_MAX = 0.0233            # realizability cap
GALPERIN = 0.53            # stable length-scale limit l N / q <= 0.53


def level25_stability(gm, gh):
    """Quasi-equilibrium level-2.5 stability functions (S_M, S_H) of G_H;
    ``gm`` enters only through the realizability clip."""
    del gm
    gh = torch.clamp(gh, -0.28, GH_MAX)
    s_h = A2 * (1.0 - 6.0 * A1 / B1) / (1.0 - 3.0 * A2 * gh * (6.0 * A1 + B2))
    s_m = (A1 * (1.0 - 3.0 * C1 - 6.0 * A1 / B1)
           + s_h * gh * (18.0 * A1 * A1 + 9.0 * A1 * A2)) \
        / (1.0 - 9.0 * A1 * A2 * gh)
    return torch.clamp(s_m, 0.0, 2.0), torch.clamp(s_h, 0.0, 3.0)


def _psi_m(zeta):
    zu = torch.clamp(zeta, max=0.0)
    x = (1.0 - 16.0 * zu) ** 0.25
    unstable = (2.0 * torch.log(0.5 * (1.0 + x)) + torch.log(0.5 * (1.0 + x * x))
                - 2.0 * torch.arctan(x) + 0.5 * torch.pi)
    zs = torch.clamp(zeta, min=0.0)
    stable = -(0.7 * zs + 0.75 * (zs - 14.28) * torch.exp(-0.35 * zs) + 10.71)
    return torch.where(zeta < 0.0, unstable, stable)


def _psi_h(zeta):
    zu = torch.clamp(zeta, max=0.0)
    y = torch.sqrt(1.0 - 16.0 * zu)
    unstable = 2.0 * torch.log(0.5 * (1.0 + y))
    zs = torch.clamp(zeta, min=0.0)
    stable = -((1.0 + 2.0 * zs / 3.0) ** 1.5
               + 0.6667 * (zs - 14.28) * torch.exp(-0.35 * zs) + 9.52 - 1.0)
    return torch.where(zeta < 0.0, unstable, stable)


def myj_surface_layer(u1, v1, th1, thsfc, z1, z0=0.1, n_iter: int = 5):
    """MYJ-class surface layer: ``n_iter`` fixed-point iterations of the
    Monin-Obukhov similarity with a viscous-sublayer scalar roughness.
    ``z1``: 0-d tensor, the first half level.  Returns dict(ustar, thstar,
    rmol, hfx_kin, ra), each [ny, nx]."""
    spd = torch.clamp(torch.sqrt(u1 * u1 + v1 * v1), min=0.1)
    dth = th1 - thsfc
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    z0t = float(torch.clamp(f32(z0) * torch.exp(f32(-c.KARMAN * 7.3)), min=1e-5))
    ln_m = torch.log(z1 / z0)
    ln_h = torch.log(z1 / z0t)

    rmol = torch.zeros_like(spd)
    ustar = c.KARMAN * spd / ln_m
    thstar = torch.zeros_like(spd)
    for _ in range(n_iter):
        zeta1 = torch.clamp(z1 * rmol, -10.0, 5.0)
        zeta0 = torch.clamp(z0 * rmol, -10.0, 5.0)
        zeta0t = torch.clamp(z0t * rmol, -10.0, 5.0)
        ustar = c.KARMAN * spd / torch.clamp(ln_m - _psi_m(zeta1) + _psi_m(zeta0),
                                             min=1.0)
        ustar = torch.clamp(ustar, min=0.01)
        thstar = c.KARMAN * dth / torch.clamp(ln_h - _psi_h(zeta1) + _psi_h(zeta0t),
                                              min=1.0)
        th_mean = 0.5 * (th1 + thsfc)
        l_inv = c.KARMAN * c.GRAV * thstar / (ustar * ustar
                                              * torch.clamp(th_mean, min=200.0))
        rmol = torch.clamp(l_inv, -0.5, 0.5)

    zeta1 = torch.clamp(z1 * rmol, -10.0, 5.0)
    zeta0t = torch.clamp(z0t * rmol, -10.0, 5.0)
    ra = (ln_h - _psi_h(zeta1) + _psi_h(zeta0t)) / (c.KARMAN * ustar)
    return dict(ustar=ustar, thstar=thstar, rmol=rmol,
                hfx_kin=-ustar * thstar, ra=torch.clamp(ra, min=1.0))


def _face_gradients(theta, u, v, z_half):
    """Shear^2 and Brunt-Vaisala N^2 at interior w faces [nz-1, ny, nx]."""
    zh = z_half.reshape(-1, 1, 1)
    dzh = torch.clamp(zh[1:] - zh[:-1], min=1.0)
    dthdz = (theta[1:] - theta[:-1]) / dzh
    dudz = (u[1:] - u[:-1]) / dzh
    dvdz = (v[1:] - v[:-1]) / dzh
    s2 = torch.clamp(dudz * dudz + dvdz * dvdz, min=1e-9)
    th_m = torch.clamp(0.5 * (theta[1:] + theta[:-1]), min=200.0)
    n2 = c.GRAV / th_m * dthdz
    return s2, n2


def myj_tke_step(q2, theta, u, v, grid, ustar, dt):
    """One prognostic level-2.5 TKE step and the exchange coefficients.

    q2: [nz+1, ny, nx] at w levels; theta/u/v at half levels [nz, ny, nx];
    ustar [ny, nx].  Returns (q2_new, exch_h, exch_m), the exchange
    coefficients at w levels [nz+1, ny, nx]."""
    zf = grid.z_full.reshape(-1, 1, 1)
    zh = grid.z_half
    s2, n2 = _face_gradients(theta, u, v, zh)

    q2i = torch.clamp(q2[1:-1], min=Q2_MIN)
    q = torch.sqrt(q2i)

    z_face = zf[1:-1]
    zh3 = zh.reshape(-1, 1, 1)
    dz_c = zh3[1:] - zh3[:-1]
    num = torch.sum(q * z_face * dz_c, dim=0)
    den = torch.clamp(torch.sum(q * dz_c, dim=0), min=1e-6)
    l0 = torch.clamp(L0_ALPHA * num / den, L0_MIN, L0_MAX)
    l_b = c.KARMAN * z_face * l0 / (c.KARMAN * z_face + l0)
    n_pos = torch.sqrt(torch.clamp(n2, min=1e-10))
    l_lim = GALPERIN * q / n_pos
    ell = torch.where(n2 > 0.0, torch.minimum(l_b, l_lim), l_b)
    ell = torch.clamp(ell, min=1.0)

    gm = (ell / q) ** 2 * s2
    gh = -((ell / q) ** 2) * n2
    s_m, s_h = level25_stability(gm, gh)
    k_m = ell * q * s_m
    k_h = ell * q * s_h
    k_q = torch.clamp(ell * q * S_Q, min=0.1)

    prod = 2.0 * (k_m * s2 - k_h * n2)
    q2_src = (q2i + dt * torch.maximum(prod, -q2i / max(dt, 1e-6))) \
        / (1.0 + 2.0 * dt * q / (B1 * ell))
    q2_src = torch.clamp(q2_src, Q2_MIN, 200.0)

    # implicit q2 transport between interior faces: the surface face is a
    # Dirichlet source at q2_sfc = B1^(2/3) u*^2, the top face zero-flux
    nz = theta.shape[0]
    q2_sfc = B1 ** (2.0 / 3.0) * torch.clamp(ustar, min=0.01) ** 2
    if nz > 2:
        k_mid = 0.5 * (k_q[1:] + k_q[:-1])
        dz_f = torch.clamp(zf[2:-1] - zf[1:-2], min=1.0)
        flux_coef = k_mid / dz_f
        dz_cell = torch.clamp(dz_c, min=1.0)
        zrow = torch.zeros_like(flux_coef[:1])
        lo_sfc = k_q[0] / torch.clamp(zf[1] - zf[0], min=1.0)
        lo = torch.cat([lo_sfc[None], flux_coef], dim=0)
        hi = torch.cat([flux_coef, zrow], dim=0)
        alpha = dt / dz_cell
        a = torch.cat([zrow, (-alpha * lo)[1:]], dim=0)
        b_d = 1.0 + alpha * (lo + hi)
        c_d = -alpha * hi
        d = torch.cat([(q2_src[0] + alpha[0] * lo_sfc * q2_sfc)[None], q2_src[1:]],
                      dim=0)
        q2_new_i = tridiag_solve(a.contiguous(), b_d.contiguous(),
                                 c_d.contiguous(), d.contiguous())
    else:
        q2_new_i = q2_src

    q2_new = torch.cat([q2_sfc[None], torch.clamp(q2_new_i, Q2_MIN, 200.0),
                        torch.full_like(q2[-1:], Q2_MIN)], dim=0)
    zero = torch.zeros_like(k_h[:1])
    k_h_full = torch.clamp(torch.clamp(torch.cat([k_h[:1], k_h, zero]), min=0.1),
                           0.0, 2000.0)
    k_m_full = torch.clamp(torch.clamp(torch.cat([k_m[:1], k_m, zero]), min=0.1),
                           0.0, 2000.0)
    return q2_new, k_h_full, k_m_full


def tke_pbl_height(q2, grid, factor: float = 2.0):
    """Diagnostic PBL height: the highest w level of the contiguous run from
    the surface where q2 exceeds ``factor x Q2_MIN``."""
    zf = grid.z_full.reshape(-1, 1, 1)
    active = q2 > factor * Q2_MIN
    contig = torch.cumprod(active.to(torch.int32), dim=0).bool()
    h = torch.amax(torch.where(contig, zf, 0.0), dim=0)
    return torch.maximum(h, zf[1, 0, 0])


def init_q2(grid):
    """Near-neutral initial q2 field [nz+1, ny, nx]."""
    return torch.full((grid.nz + 1, grid.ny, grid.nx), Q2_MIN,
                      dtype=torch.float32, device=grid.dz.device)
