"""Kessler warm rain (mp_physics=1) and WSM5-class ice (mp_physics=2)
bulk microphysics, with the helpers the Morrison scheme shares.

Port of ``wrf_partmc_tpu/models/physics/microphysics.py``: saturation
adjustment with latent heating, autoconversion, accretion, rain
evaporation and upwind sedimentation; WSM5 adds the mixed-phase
adjustment, freezing and melting, ice-to-snow conversion, riming,
depositional growth of snow and two more sedimenting species.  Both run as
the adjustment after the dycore step, on moist = [qv, qc, qr(, qi, qs)].
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...grid import Grid
from ..dycore.state import DycoreState, base_profiles, temperature, total_pressure
from .thermo import saturation_mixing_ratio

K_AUTO = 1.0e-3        # autoconversion rate [s-1]
QC0 = 1.0e-3           # autoconversion threshold [kg kg-1]
K_ACCR = 2.2           # accretion coefficient
VT_COEF = 36.34        # rain fall speed coefficient (Kessler)

QI0_AUTO = 1.0e-4      # ice -> snow autoconversion threshold [kg kg-1]
K_AUTO_I = 1.0e-3      # ice autoconversion rate [s-1]
K_ACCR_S = 1.0         # snow accretion (of ice/cloud) coefficient
VT_SNOW = 5.40         # snow fall speed coefficient
VT_ICE = 3.29          # ice crystal fall speed coefficient
TAU_DEP = 600.0        # depositional growth relaxation time [s]


def rain_fall_speed(qr, rho):
    """Mass-weighted rain terminal velocity [m s-1]."""
    return VT_COEF * torch.clamp(rho * qr, min=0.0) ** 0.1346 * torch.sqrt(1.2 / rho)


def _with_moist(state: DycoreState, theta, *fields) -> DycoreState:
    """state with theta' and the leading moist fields replaced."""
    moist = state.moist.clone()
    for i, f in enumerate(fields):
        moist[i] = f
    return dataclasses.replace(state, moist=moist, theta_p=theta)


def kessler_step(state: DycoreState, grid: Grid, dt) -> DycoreState:
    """One Kessler adjustment; moist = [qv, qc, qr] (n_moist >= 3)."""
    qv = torch.clamp(state.moist[0], min=0.0)
    qc = torch.clamp(state.moist[1], min=0.0)
    qr = torch.clamp(state.moist[2], min=0.0)
    rho_b, _, _ = base_profiles(grid)
    rho = rho_b.reshape(-1, 1, 1)
    temp = temperature(state, grid)
    pres = total_pressure(state, grid)
    qsat = saturation_mixing_ratio(temp, pres)
    exner = (pres / c.P0) ** c.KAPPA
    lv_cp = c.WATER_LATENT_HEAT / (c.CP * exner)

    # saturation adjustment (one Newton step with the qsat sensitivity)
    dqsat_dT = qsat * c.WATER_LATENT_HEAT / (c.R_V * temp * temp)
    cond = (qv - qsat) / (1.0 + lv_cp * exner * dqsat_dT)
    cond = torch.maximum(cond, -qc)
    qv = qv - cond
    qc = qc + cond
    theta = state.theta_p + lv_cp * cond

    # autoconversion + accretion
    auto = K_AUTO * dt * torch.clamp(qc - QC0, min=0.0)
    accr = dt * K_ACCR * qc * torch.clamp(qr, min=0.0) ** 0.875
    to_rain = torch.minimum(auto + accr, qc)
    qc = qc - to_rain
    qr = qr + to_rain

    # rain evaporation in subsaturated air
    subsat = torch.clamp(qsat - qv, min=0.0)
    evap = torch.minimum(torch.minimum(0.1 * dt * subsat, qr), subsat)
    qr = qr - evap
    qv = qv + evap
    theta = theta - lv_cp * evap

    # sedimentation: upwind downward flux of rho*qr
    vt = rain_fall_speed(qr, rho)
    flux = rho * qr * vt
    rdz = (1.0 / grid.dz).reshape(-1, 1, 1)
    flux_in = torch.cat([flux[1:], torch.zeros_like(flux[:1])], dim=0)
    dqr = dt * (flux_in - flux) * rdz / rho
    qr = torch.clamp(qr + dqr, min=0.0)
    return _with_moist(state, theta, qv, torch.clamp(qc, min=0.0), qr)


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


def wsm5_step(state: DycoreState, grid: Grid, dt) -> DycoreState:
    """One 5-class adjustment; moist = [qv, qc, qr, qi, qs] (n_moist >= 5)."""
    qv = torch.clamp(state.moist[0], min=0.0)
    qc = torch.clamp(state.moist[1], min=0.0)
    qr = torch.clamp(state.moist[2], min=0.0)
    qi = torch.clamp(state.moist[3], min=0.0)
    qs = torch.clamp(state.moist[4], min=0.0)
    rho_b, _, _ = base_profiles(grid)
    rho = rho_b.reshape(-1, 1, 1)
    temp = temperature(state, grid)
    pres = total_pressure(state, grid)
    exner = (pres / c.P0) ** c.KAPPA
    theta = state.theta_p

    lv_cp = c.WATER_LATENT_HEAT / (c.CP * exner)
    ls_cp = c.ICE_LATENT_HEAT_SUB / (c.CP * exner)
    lf_cp = c.ICE_LATENT_HEAT_FUS / (c.CP * exner)

    qsw = saturation_mixing_ratio(temp, pres)
    qsi = sat_mixing_ratio_ice(temp, pres)
    # ice partition ramp: all liquid at T0, all ice at T_HOMOG
    fice = torch.clamp((c.T_FREEZE - temp) / (c.T_FREEZE - c.T_HOMOG), 0.0, 1.0)
    qsat = (1.0 - fice) * qsw + fice * qsi
    l_cp = (1.0 - fice) * lv_cp + fice * ls_cp

    # mixed-phase saturation adjustment (one Newton step)
    L_blend = (1.0 - fice) * c.WATER_LATENT_HEAT + fice * c.ICE_LATENT_HEAT_SUB
    dqsat_dT = qsat * L_blend / (c.R_V * temp * temp)
    cond = (qv - qsat) / (1.0 + l_cp * exner * dqsat_dT)
    cond = torch.maximum(cond, -(qc + qi))
    qv = qv - cond
    dqc = torch.where(cond >= 0.0, (1.0 - fice) * cond, -torch.minimum(-cond, qc))
    dqi = cond - dqc
    dqi = torch.maximum(dqi, -qi)
    qc = torch.clamp(qc + dqc, min=0.0)
    qi = torch.clamp(qi + dqi, min=0.0)
    theta = theta + lv_cp * dqc + ls_cp * dqi

    # homogeneous freezing / melting of the cloud species
    frz = torch.where(temp < c.T_HOMOG, qc, 0.0)
    qc, qi = qc - frz, qi + frz
    theta = theta + lf_cp * frz
    mlt_i = torch.where(temp > c.T_FREEZE, qi, 0.0)
    qi, qc = qi - mlt_i, qc + mlt_i
    theta = theta - lf_cp * mlt_i

    # warm-rain conversions (Kessler forms)
    auto = K_AUTO * dt * torch.clamp(qc - QC0, min=0.0)
    accr = dt * K_ACCR * qc * torch.clamp(qr, min=0.0) ** 0.875
    to_rain = torch.minimum(auto + accr, qc)
    qc, qr = qc - to_rain, qr + to_rain

    # ice -> snow autoconversion + snow accretion of ice
    auto_i = K_AUTO_I * dt * torch.clamp(qi - QI0_AUTO, min=0.0)
    accr_i = dt * K_ACCR_S * qi * torch.clamp(qs, min=0.0) ** 0.875
    to_snow = torch.minimum(auto_i + accr_i, qi)
    qi, qs = qi - to_snow, qs + to_snow

    # snow riming of cloud water below freezing
    rim = torch.where(temp < c.T_FREEZE,
                      torch.minimum(dt * K_ACCR_S * qc
                                    * torch.clamp(qs, min=0.0) ** 0.875, qc), 0.0)
    qc, qs = qc - rim, qs + rim
    theta = theta + lf_cp * rim

    # depositional growth / sublimation of snow
    ssi = qv - qsi
    dep = torch.where((temp < c.T_FREEZE) & (qs > 0.0),
                      ssi * (1.0 - torch.exp(ssi.new_full((), -dt / TAU_DEP))), 0.0)
    dep = torch.maximum(dep, -qs)
    qv, qs = qv - dep, qs + dep
    theta = theta + ls_cp * dep

    # snow melting above freezing (heat-capacity limited)
    melt_cap = c.CP * torch.clamp(temp - c.T_FREEZE, min=0.0) / c.ICE_LATENT_HEAT_FUS
    melt = torch.minimum(qs, melt_cap)
    qs, qr = qs - melt, qr + melt
    theta = theta - lf_cp * melt

    # rain evaporation (subsaturated)
    subsat = torch.clamp(qsw - qv, min=0.0)
    evap = torch.minimum(torch.minimum(0.1 * dt * subsat, qr), subsat)
    qr, qv = qr - evap, qv + evap
    theta = theta - lv_cp * evap

    # sedimentation
    qr = _sediment(qr, rho, rain_fall_speed(qr, rho), grid.dz, dt)
    vt_s = VT_SNOW * torch.clamp(rho * qs, min=0.0) ** 0.0625 * torch.sqrt(1.2 / rho)
    qs = _sediment(qs, rho, vt_s, grid.dz, dt)
    vt_i = VT_ICE * torch.clamp(rho * qi, min=0.0) ** 0.16
    qi = _sediment(qi, rho, vt_i, grid.dz, dt)
    return _with_moist(state, theta, qv, qc, qr, qi, qs)
