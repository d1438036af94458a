"""Betts-Miller-Janjic-class convective adjustment (cu_physics=2).

Port of ``wrf_partmc_tpu/models/physics/cumulus.py``: a pseudoadiabatic
parcel from the lowest layer (four Newton steps on theta_e per level),
CAPE and cloud top from its buoyancy; in deep columns (CAPE above
``CAPE_MIN``, top above ``MIN_DEPTH``) temperature and humidity relax over
``TAU_BM`` toward an enthalpy-conserving reference profile and a
sub-saturated reference humidity.  The net column moisture removal is the
convective rain.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...grid import Grid
from ..dycore.state import DycoreState, layer_depths, temperature, total_pressure
from .thermo import saturation_mixing_ratio

LV = c.WATER_LATENT_HEAT

TAU_BM = 2400.0          # adjustment timescale [s]
CAPE_MIN = 150.0         # [J/kg]
MIN_DEPTH = 3000.0       # [m] deep-convection depth threshold
SUBSAT = (0.95, 0.85, 0.75)   # sub-saturation at base / mid / top


def _parcel_profile(temp, qv, pres):
    """Pseudoadiabatic parcel temperature from the lowest layer [nz, ...]."""
    t0 = temp[0]
    q0 = qv[0]
    p0 = pres[0]
    th0 = t0 * (c.P0 / p0) ** c.KAPPA
    th_e = th0 * torch.exp(LV * q0 / (c.CP * t0))

    # invert theta_e = th(T, p) exp(Lv qs(T, p) / (cp T)) for T at each level
    t_p = t0.expand(temp.shape)
    for _ in range(4):
        qs = saturation_mixing_ratio(t_p, pres)
        th = t_p * (c.P0 / pres) ** c.KAPPA
        f = th * torch.exp(LV * qs / (c.CP * t_p)) - th_e[None]
        dqs_dt = qs * LV / (c.R_V * t_p ** 2)
        dfdt = (th / t_p) * torch.exp(LV * qs / (c.CP * t_p)) * (
            1.0 + LV * dqs_dt / c.CP - LV * qs / (c.CP * t_p))
        t_p = torch.clamp(t_p - f / torch.clamp(dfdt, min=1e-3), 150.0, 330.0)
    # below the LCL (parcel still unsaturated) follow the dry adiabat
    t_dry = t0[None] * (pres / p0[None]) ** c.KAPPA
    return torch.where(saturation_mixing_ratio(t_dry, pres) > q0[None], t_dry, t_p)


def bmj_step(state: DycoreState, grid: Grid, dt):
    """One convective-adjustment step.  Returns (new_state, rain rate
    [kg m-2 s-1] [ny, nx])."""
    temp = temperature(state, grid)
    pres = total_pressure(state, grid)
    qv = state.moist[0]
    dz = layer_depths(state, grid, temp.shape)
    rho = pres / (c.R_D * temp)
    dm = rho * dz                                        # layer mass [kg/m2]

    t_parcel = _parcel_profile(temp, qv, pres)
    buoy = (t_parcel - temp) / temp
    cape = torch.sum(torch.clamp(buoy, min=0.0) * c.GRAV * dz, dim=0)
    z = torch.cumsum(dz, dim=0) - 0.5 * dz
    top_z = torch.amax(torch.where(buoy > 0.0, z, 0.0), dim=0)
    deep = (cape > CAPE_MIN) & (top_z > MIN_DEPTH)

    in_cloud = (buoy > -0.02) & (z < top_z[None])
    # reference T: mostly the environment, nudged toward the parcel curve,
    # shifted so that cp dT sums to zero over the cloud
    t_ref = temp + 0.25 * (t_parcel - temp)
    w_cl = torch.where(in_cloud, dm, 0.0)
    shift = (torch.sum(w_cl * (t_ref - temp), dim=0)
             / torch.clamp(torch.sum(w_cl, dim=0), min=1e-3))
    t_ref = t_ref - shift[None]
    frac = torch.clamp(z / torch.clamp(top_z[None], min=1.0), 0.0, 1.0)
    subsat = (SUBSAT[0] * (1 - frac) ** 2 + SUBSAT[1] * 2 * frac * (1 - frac)
              + SUBSAT[2] * frac ** 2)
    q_ref = subsat * saturation_mixing_ratio(t_ref, pres)

    relax = torch.where(deep[None] & in_cloud, dt / TAU_BM, 0.0)
    d_t = relax * (t_ref - temp)
    d_q = relax * (torch.minimum(q_ref, qv * 1.5) - qv)
    # rain = net column moisture removal; a column that would moisten is
    # left alone
    rain_col = -torch.sum(d_q * dm, dim=0) / dt
    pos = rain_col > 0.0
    d_q = torch.where(pos[None], d_q, 0.0)
    d_t = torch.where(pos[None], d_t, 0.0)
    rain = torch.clamp(rain_col, min=0.0) * pos
    # condensation heating of the removed moisture, spread with the
    # weights of the T adjustment
    exner = (pres / c.P0) ** c.KAPPA
    heat_budget = LV * torch.sum(-d_q * dm, dim=0) / c.CP
    wsum = torch.clamp(torch.sum(torch.abs(d_t) * dm, dim=0), min=1e-6)
    d_t = d_t + torch.abs(d_t) * (heat_budget - torch.sum(d_t * dm, dim=0)
                                  )[None] / wsum[None]

    theta_p = state.theta_p + d_t / exner
    moist = state.moist.clone()
    moist[0] = torch.clamp(qv + d_q, min=0.0)
    return dataclasses.replace(state, theta_p=theta_p, moist=moist), rain
