"""Grell-class ensemble mass-flux deep convection (cu_physics=5).

Port of ``wrf_partmc_tpu/models/physics/grell.py``: an entraining updraft
plume from the level of maximum moist static energy below 3 km, run for
three entrainment members at once; buoyancy, cloud top and cloud work
function; a CAPE-removal closure for the base mass flux; compensating
subsidence with a detrainment layer, and an evaporative downdraft below the
origin; the members' tendencies averaged with equal weights.  The
reference's ``lax.scan`` up the column is a Python loop over levels here.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...grid import Grid
from ..dycore.state import DycoreState, layer_depths, temperature, total_pressure
from .thermo import saturation_mixing_ratio

LV = c.WATER_LATENT_HEAT

ENTR_MEMBERS = (7e-5, 1.4e-4, 2.8e-4)   # fractional entrainment [1/m]
DETR_RATIO = 0.5                         # delta = DETR_RATIO * eps
TAU_G = 3600.0                           # CAPE-removal timescale [s]
MIN_DEPTH_G = 3000.0                     # [m]
A_MIN = 40.0                             # [J/kg] trigger work function
BETA_DD = 0.3                            # downdraft evaporation fraction
Z_ORIGIN_MAX = 3000.0                    # updraft source search depth [m]


def grell_step(state: DycoreState, grid: Grid, dt):
    """One ensemble mass-flux step.  Returns (new_state, rain rate
    [kg m-2 s-1] [ny, nx])."""
    temp = temperature(state, grid)
    pres = total_pressure(state, grid)
    qv = torch.clamp(state.moist[0], min=0.0)
    dz = layer_depths(state, grid, temp.shape)
    rho = pres / (c.R_D * temp)
    dm = rho * dz
    z = torch.cumsum(dz, dim=0) - 0.5 * dz
    qs = saturation_mixing_ratio(temp, pres)
    h = c.CP * temp + c.GRAV * z + LV * qv
    h_sat = c.CP * temp + c.GRAV * z + LV * qs

    # 1. updraft origin: the lowest level of maximum h below Z_ORIGIN_MAX
    h_msk = torch.where(z < Z_ORIGIN_MAX, h, -1e30)
    h0 = torch.amax(h_msk, dim=0)
    is0 = h_msk == h0[None]
    first0 = torch.cumsum(torch.cumsum(is0.to(torch.int32), dim=0), dim=0) == 1
    z0 = torch.sum(torch.where(first0, z, 0.0), dim=0)
    q0 = torch.sum(torch.where(first0, qv, 0.0), dim=0)

    # 2. entraining plume up the column, the members on a leading axis
    n_m = len(ENTR_MEMBERS)
    eps = torch.tensor(ENTR_MEMBERS, dtype=torch.float32,
                       device=temp.device).reshape(n_m, 1, 1)
    above = z >= z0[None]
    h_u = h0[None].expand(n_m, *h0.shape)
    q_u = q0[None].expand(n_m, *h0.shape)
    eta = torch.ones((n_m,) + tuple(h0.shape), dtype=torch.float32, device=temp.device)
    outs = []
    for k in range(temp.shape[0]):
        ed = eps * dz[k][None]
        h_new = (h_u + ed * h[k][None]) / (1.0 + ed)
        q_new = (q_u + ed * qv[k][None]) / (1.0 + ed)
        cond = torch.clamp(q_new - qs[k][None], min=0.0)
        q_new = q_new - cond
        eta_new = eta * (1.0 + (1.0 - DETR_RATIO) * ed)
        up = above[k][None]
        h_u = torch.where(up, h_new, h0[None])
        q_u = torch.where(up, q_new, q0[None])
        eta = torch.where(up, eta_new, 1.0)
        outs.append((h_u, eta, torch.where(up, cond, 0.0)))
    h_u, eta, cond = (torch.stack(a, dim=1) for a in zip(*outs))   # [n_m, nz, ny, nx]

    # 3. buoyancy, cloud top, work function
    buoy = (h_u - h_sat[None]) / (c.CP * temp[None])
    pos = (buoy > 0.0) & above[None]
    z_top = torch.amax(torch.where(pos, z[None], 0.0), dim=1)
    in_cloud = above[None] & (z[None] <= z_top[:, None])
    gamma = LV * LV * qs / (c.CP * c.R_V * temp ** 2)
    a_wf = torch.sum(torch.where(pos, c.GRAV * buoy / (1.0 + gamma[None])
                                 * eta * dz[None], 0.0), dim=1)
    z_lfc = torch.amin(torch.where(pos, z[None], 1e9), dim=1)
    deep = ((a_wf > A_MIN) & ((z_top - z0[None]) > MIN_DEPTH_G)
            & ((z_lfc - z0[None]) < 2000.0))

    # 4. unit-subsidence tendencies, the net flux tapering to zero across
    # the top 40% of the cloud; closure from their effect on the work
    # function
    depth = torch.clamp(z_top[:, None] - z0[None, None], min=1.0)
    z_frac = (z[None] - z0[None, None]) / depth
    taper = torch.clamp((1.0 - z_frac) / 0.4, 0.0, 1.0)
    eta_sub = eta * taper
    dtdz = torch.gradient(temp, dim=0)[0] / torch.clamp(dz, min=1.0)
    dqdz = torch.gradient(qv, dim=0)[0] / torch.clamp(dz, min=1.0)
    dT_unit = eta_sub / rho[None] * (dtdz[None] + c.GRAV / c.CP)
    dq_unit = eta_sub / rho[None] * dqdz[None]
    dT_unit = torch.where(in_cloud, dT_unit, 0.0)
    dq_unit = torch.where(in_cloud, dq_unit, 0.0)
    dA_unit = torch.sum(torch.where(
        pos, c.GRAV / temp[None] * (dT_unit + LV / c.CP * dq_unit) * dz[None], 0.0),
        dim=1)
    m_b = torch.where(deep, a_wf / (TAU_G * torch.clamp(dA_unit, min=1e-6)), 0.0)
    m_cap = torch.amin(torch.where(in_cloud, dm[None], 1e9), dim=1) / dt
    m_b = torch.clamp(m_b, min=0.0)
    m_b = torch.minimum(m_b, 0.5 * m_cap)

    # 5. member tendencies: subsidence, detrainment-layer moistening,
    # precipitation and the downdraft below the origin
    dT = m_b[:, None] * dT_unit
    dq = m_b[:, None] * dq_unit
    eta_above = torch.cat([eta_sub[:, 1:], torch.zeros_like(eta_sub[:, :1])], dim=1)
    det_w = torch.where(in_cloud, torch.clamp(eta_sub - eta_above, min=0.0), 0.0)
    det_q = m_b[:, None] * det_w * torch.clamp(qs[None] - qv[None], min=0.0) / dm[None]
    dq = dq + det_q
    rain_prod = m_b * torch.sum(eta * cond, dim=1)
    sub = z[None] < z0[None, None]
    w_sub = torch.where(sub, dm[None], 0.0)
    w_sub_tot = torch.clamp(torch.sum(w_sub, dim=1), min=1e-3)
    evap = BETA_DD * rain_prod
    dq = dq + evap[:, None] * w_sub / w_sub_tot[:, None] / dm[None]
    dT = dT - LV / c.CP * evap[:, None] * w_sub / w_sub_tot[:, None] / dm[None]
    rain_m = (1.0 - BETA_DD) * rain_prod

    dT_e = torch.mean(dT, dim=0)
    dq_e = torch.mean(dq, dim=0)
    rain = torch.mean(rain_m, dim=0)

    dq_e = torch.maximum(dq_e, -qv / dt)
    exner = (pres / c.P0) ** c.KAPPA
    theta_p = state.theta_p + dt * dT_e / exner
    moist = torch.cat([torch.clamp(qv + dt * dq_e, min=0.0)[None], state.moist[1:]])
    return (dataclasses.replace(state, theta_p=theta_p, moist=moist),
            torch.clamp(rain, min=0.0))
