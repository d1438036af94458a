"""Morrison-class two-moment bulk microphysics (mp_physics=10).

Port of ``wrf_partmc_tpu/models/physics/morrison.py``: vapor, cloud, rain,
ice, snow and (with ``n_moist == 10``, the CARES set) graupel, with
prognostic number for rain, ice, snow and graupel, inverse-exponential
spectra, double-moment process rates limited so that no species loses more
than it holds, a saturation adjustment for cloud water, and moment-weighted
sedimentation.

Moist-axis layout: 0 qv, 1 qc, 2 qr, 3 qi, 4 qs, then with graupel
5 qg, 6 nr, 7 ni, 8 ns, 9 ng; without it 5 nr, 6 ni, 7 ns.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...grid import Grid
from ..dycore.state import DycoreState, layer_depths, temperature, total_pressure
from .microphysics import _sediment, sat_mixing_ratio_ice
from .thermo import saturation_mixing_ratio as sat_mixing_ratio

LV = c.WATER_LATENT_HEAT

NDCNST = 250.0e6        # fixed cloud-droplet number [# m-3]
RHO_W = 1000.0
RHO_I = 500.0
RHO_S = 100.0
LS = c.ICE_LATENT_HEAT_SUB
LF = c.ICE_LATENT_HEAT_FUS

# fall speed power laws V = a D^b [SI]
AR, BR = 841.99667, 0.8       # rain
AI, BI = 700.0, 1.0           # cloud ice
AS, BS = 11.72, 0.41          # snow
AG, BG = 19.3, 0.37           # graupel
RHO_G = 400.0
M_G0 = 3.0e-9                 # embryo graupel mass


def _gamma(x: float) -> torch.Tensor:
    """Gamma(x) as exp(lgamma(x)) in float32, a 0-d CPU tensor (a scalar
    operand on any device)."""
    return torch.exp(torch.lgamma(torch.tensor(x, dtype=torch.float32)))


def _slope(q, n, rho, rho_p, lam_min, lam_max):
    """Inverse-exponential slope lambda = (pi rho_p n / q)^(1/3), clamped;
    returns (lambda, n0)."""
    lam = (torch.pi * rho_p * torch.clamp(n, min=1.0)
           / torch.clamp(q, min=1e-14)) ** (1.0 / 3.0)
    lam = torch.clamp(lam, lam_min, lam_max)
    return lam, n * lam


def _limit(avail, sink, dt):
    """min(1, max(avail, 0) / max(sink dt, 1e-30)): the factor that keeps a
    species' sinks within what it holds."""
    return torch.clamp(torch.clamp(avail, min=0.0) / torch.clamp(sink * dt, min=1e-30),
                       max=1.0)


def morrison_step(state: DycoreState, grid: Grid, dt) -> DycoreState:
    """One adjustment-slot microphysics step."""
    m = state.moist
    has_g = m.shape[0] >= 10
    qv, qc, qr, qi, qs = (m[0], m[1], m[2], m[3], m[4])
    pos = lambda a: torch.clamp(a, min=0.0)
    if has_g:
        qg = pos(m[5])
        nr, ni, ns, ng = pos(m[6]), pos(m[7]), pos(m[8]), pos(m[9])
    else:
        qg = torch.zeros_like(qr)
        ng = torch.zeros_like(qr)
        nr, ni, ns = pos(m[5]), pos(m[6]), pos(m[7])
    temp = temperature(state, grid)
    pres = total_pressure(state, grid)
    rho = pres / (c.R_D * temp)
    t0c = 273.15
    cold = temp < t0c
    zero = torch.zeros_like(temp)

    lam_r, _ = _slope(qr, nr, rho, RHO_W, 1e3, 1e5)
    lam_i, _ = _slope(qi, ni, rho, RHO_I, 1e3, 1e7)
    lam_s, _ = _slope(qs, ns, rho, RHO_S, 1e2, 1e5)
    lam_g, _ = _slope(qg, ng, rho, RHO_G, 1e2, 1e5)

    # warm rain (KK2000)
    nc = NDCNST / rho
    prc = 1350.0 * pos(qc) ** 2.47 * (nc * 1e-6 * rho) ** (-1.79)
    nprc = prc / (4.0 / 3.0 * torch.pi * RHO_W * (25e-6) ** 3) / rho
    pra = 67.0 * pos(qc * qr) ** 1.15
    nragg = 8.0 * nr * qr * rho

    # rain evaporation (sub-saturated), ventilated
    qvs = sat_mixing_ratio(temp, pres)
    ssw = qv / torch.clamp(qvs, min=1e-12) - 1.0
    dv = 8.794e-5 * temp ** 1.81 / pres
    ab_w = 1.0 + LV ** 2 * qvs / (c.CP * c.R_V * temp ** 2)

    def vent(n, lam, a, b):
        return (0.78 * n * lam ** (-1.0)
                + 0.308 * 0.9 * (n * lam) * torch.sqrt(a * rho ** 0.5)
                * _gamma(2.5 + b / 2.0) * lam ** (-(2.5 + b / 2.0)))

    vent_r = vent(nr, lam_r, AR, BR)
    pre = torch.where(ssw < 0.0, 2.0 * torch.pi * dv * ssw * vent_r / ab_w, 0.0)
    pre = torch.maximum(pre, -qr / dt)
    per_q = lambda rate, n, q: torch.where(q > 1e-12, rate * n / torch.clamp(q, min=1e-12),
                                           0.0)
    npre = per_q(pre, nr, qr)

    # ice nucleation (Cooper 1986) + deposition growth
    qvi = sat_mixing_ratio_ice(temp, pres)
    ssi = qv / torch.clamp(qvi, min=1e-12) - 1.0
    n_nuc = torch.where(cold & (ssi > 0.05),
                        0.005 * torch.exp(0.304 * (t0c - temp)) * 1e3, 0.0)
    n_nuc = torch.clamp(n_nuc, max=1e8) / rho
    pnuc_n = pos(n_nuc - ni) / dt
    pnuc_q = pnuc_n * 1e-12
    ab_i = 1.0 + LS ** 2 * qvi / (c.CP * c.R_V * temp ** 2)
    prd = torch.where(cold, 2.0 * torch.pi * dv * ssi * ni / (ab_i * lam_i), 0.0)
    dep_max = pos(qv - qvi) / dt
    prd = torch.clamp(prd, -qi / dt, dep_max)

    # ice -> snow autoconversion (size threshold 125 um)
    frac_big = torch.exp(-lam_i * 125e-6)
    prci = torch.where(cold, qi * frac_big / (dt * 3.0), 0.0)
    nprci = torch.where(cold, ni * frac_big / (dt * 3.0), 0.0)

    # snow deposition + aggregation + riming
    vent_s = vent(ns, lam_s, AS, BS)
    prds = torch.where(cold, 2.0 * torch.pi * dv * ssi * vent_s / ab_i, 0.0)
    prds = torch.clamp(prds, -qs / dt, dep_max)
    nsagg = torch.where(cold, 0.1 * ns * qs * rho, 0.0)
    eff = 0.8
    psacw = torch.where(cold, torch.pi / 4.0 * eff * AS * rho ** 0.5 * qc * ns
                        * _gamma(3.0 + BS) * lam_s ** (-(3.0 + BS)), 0.0)

    # rain freezing (Bigg 1953) below -4 C, supercooling clamped to 40 K
    bigg = torch.where(temp < t0c - 4.0,
                       100.0 * (torch.exp(0.66 * torch.clamp(t0c - temp, max=40.0))
                                - 1.0), 0.0)
    pgfr = torch.pi ** 2 / 36.0 * RHO_W / rho * bigg * nr \
        * _gamma(7.0) * lam_r ** (-6.0)
    pgfr = torch.minimum(pgfr, qr / dt)
    ngfr = per_q(pgfr, nr, qr)

    # graupel processes
    if has_g:
        conv = cold & (psacw > 2.0 * pos(prds)) & (qs > 1e-7)
        pgsacw = torch.where(conv, 0.5 * psacw, 0.0)
        psacw = psacw - pgsacw
        ngsacw = pgsacw / M_G0
    else:
        pgsacw = torch.zeros_like(psacw)
        ngsacw = pgsacw
    gcol = torch.pi / 4.0 * AG * rho ** 0.5 * ng \
        * _gamma(3.0 + BG) * lam_g ** (-(3.0 + BG))
    pgacw = torch.where(cold, 0.7 * qc * gcol, 0.0)
    pgacr = torch.where(cold, 1.0 * qr * gcol, 0.0)
    ngacr = per_q(pgacr, nr, qr)
    vent_g = vent(ng, lam_g, AG, BG)
    kair = 0.024
    pgwet = torch.where(
        cold,
        2.0 * torch.pi * (kair * (t0c - temp) + LV * dv * rho * pos(qvs - qv))
        * vent_g / (rho * (LF + 4187.0 * (t0c - temp) + 1.0)), 1e9)
    prdg = torch.where(cold, 2.0 * torch.pi * dv * ssi * vent_g / ab_i, 0.0)
    prdg = torch.clamp(prdg, -qg / dt, dep_max)

    # melting above 0 C
    melt_rate = pos(temp - t0c) / (dt * 50.0)
    warm = ~cold
    pim = torch.where(warm, torch.minimum(qi / dt, qi * melt_rate / 1e-3), 0.0)
    psm = torch.where(warm, torch.minimum(qs / dt, qs * melt_rate / 1e-3), 0.0)
    pgm = torch.where(warm, torch.minimum(qg / dt, qg * melt_rate / 2e-3), 0.0)
    nim = per_q(pim, ni, qi)
    nsm = per_q(psm, ns, qs)
    ngm = per_q(pgm, ng, qg)

    # conservation-limited process application
    sink_v = pos(pnuc_q) + pos(prd) + pos(prds) + pos(prdg)
    fv = _limit(qv, sink_v, dt)
    pnuc_q = pnuc_q * fv
    pnuc_n = pnuc_n * fv
    prd = torch.where(prd > 0, prd * fv, prd)
    prds = torch.where(prds > 0, prds * fv, prds)
    prdg = torch.where(prdg > 0, prdg * fv, prdg)
    sink_c = prc + pra + psacw + pgsacw + pgacw
    fc = _limit(qc, sink_c, dt)
    prc, nprc, pra, psacw = prc * fc, nprc * fc, pra * fc, psacw * fc
    pgsacw, ngsacw, pgacw = pgsacw * fc, ngsacw * fc, pgacw * fc
    sink_i = prci + pim + pos(-prd)
    fi = _limit(qi, sink_i, dt)
    prci, nprci, pim, nim = prci * fi, nprci * fi, pim * fi, nim * fi
    prd = torch.where(prd < 0, prd * fi, prd)
    sink_r = pgfr + pgacr + pos(-pre)
    fr = _limit(qr, sink_r, dt)
    pgfr, ngfr = pgfr * fr, ngfr * fr
    pgacr, ngacr = pgacr * fr, ngacr * fr
    pre = torch.where(pre < 0, pre * fr, pre)
    npre = torch.where(pre < 0, npre * fr, npre)
    sink_s = psm + pos(-prds)
    fs = _limit(qs, sink_s, dt)
    psm, nsm = psm * fs, nsm * fs
    prds = torch.where(prds < 0, prds * fs, prds)
    sink_g = pgm + pos(-prdg)
    fg = _limit(qg, sink_g, dt)
    pgm, ngm = pgm * fg, ngm * fg
    prdg = torch.where(prdg < 0, prdg * fg, prdg)

    # wet-growth split: the unfrozen collected water sheds back to rain
    dry = pgacw + pgacr
    f_frz = torch.clamp(pgwet / torch.clamp(dry, min=1e-30), max=1.0)
    pshed = dry * (1.0 - f_frz)
    pgacw_f = pgacw * f_frz
    pgacr_f = pgacr * f_frz

    pgfr_s = zero if has_g else pgfr
    pgfr_g = pgfr - pgfr_s
    dqc = -(prc + pra + psacw + pgsacw + pgacw) * dt + pim * dt
    dqr = (prc + pra - pgfr - pgacr + pshed) * dt + pre * dt + (psm + pgm) * dt
    dqi = (pnuc_q + prd - prci - pim) * dt
    dqs = (prci + prds + psacw + pgfr_s - psm) * dt
    dqg = (pgfr_g + pgsacw + pgacw_f + pgacr_f + prdg - pgm) * dt
    dqv = -(pnuc_q + prd + prds + prdg) * dt - pre * dt

    qc1 = pos(qc + dqc)
    qr1 = pos(qr + dqr)
    qi1 = pos(qi + dqi)
    qs1 = pos(qs + dqs)
    qg1 = pos(qg + dqg)
    qv1 = pos(qv + dqv)
    nr1 = pos(nr + (nprc - nragg - ngfr + nsm + ngm + npre - ngacr * f_frz) * dt)
    ni1 = pos(ni + (pnuc_n - nprci - nim) * dt)
    ns1 = pos(ns + (nprci + (zero if has_g else ngfr) - nsagg - nsm) * dt)
    ng1 = pos(ng + ((ngfr if has_g else zero) + ngsacw - ngm) * dt)

    # latent heating -> theta
    exner = (pres / c.P0) ** c.KAPPA
    heat = (LV * (-pre) + LS * (pnuc_q + prd + prds + prdg)
            + LF * (pgfr + psacw + pgsacw + pgacw_f + pgacr_f
                    - pim - psm - pgm)) * dt / (c.CP * exner)

    # saturation adjustment for cloud water
    temp1 = temp + heat * exner
    qvs1 = sat_mixing_ratio(temp1, pres)
    ab1 = 1.0 + LV ** 2 * qvs1 / (c.CP * c.R_V * temp1 ** 2)
    cond = torch.maximum((qv1 - qvs1) / ab1, -qc1)
    qv1 = qv1 - cond
    qc1 = qc1 + cond
    heat = heat + LV * cond / (c.CP * exner)

    # sedimentation with moment-weighted fall speeds
    def fall_speed(a, b, lam, mom):
        return a * _gamma(1.0 + b + mom) / _gamma(1.0 + mom) \
            * lam ** (-b) * (1.2 / rho) ** 0.5

    lam_r1, _ = _slope(qr1, nr1, rho, RHO_W, 1e3, 1e5)
    lam_i1, _ = _slope(qi1, ni1, rho, RHO_I, 1e3, 1e7)
    lam_s1, _ = _slope(qs1, ns1, rho, RHO_S, 1e2, 1e5)
    lam_g1, _ = _slope(qg1, ng1, rho, RHO_G, 1e2, 1e5)
    dz = layer_depths(state, grid, qr1.shape)

    species = [(qr1, nr1, lam_r1, AR, BR, 9.0, "r"),
               (qi1, ni1, lam_i1, AI, BI, 9.0, "i"),
               (qs1, ns1, lam_s1, AS, BS, 9.0, "s")]
    if has_g:
        species.append((qg1, ng1, lam_g1, AG, BG, 20.0, "g"))
    out = {}
    for (q_, n_, lam_, a_, b_, vmax, tag) in species:
        vq = torch.clamp(fall_speed(a_, b_, lam_, 3.0), 0.0, vmax)
        vn = torch.clamp(fall_speed(a_, b_, lam_, 0.0), 0.0, vmax)
        out[tag] = (_sediment(q_, rho, vq, dz, dt), _sediment(n_, rho, vn, dz, dt))
    qr1, nr1 = out["r"]
    qi1, ni1 = out["i"]
    qs1, ns1 = out["s"]

    rows = list(m.unbind(0))
    rows[:5] = [qv1, qc1, qr1, qi1, qs1]
    if has_g:
        qg1, ng1 = out["g"]
        rows[5:10] = [qg1, nr1, ni1, ns1, ng1]
    else:
        rows[5:8] = [nr1, ni1, ns1]
    return dataclasses.replace(state, moist=torch.stack(rows),
                               theta_p=state.theta_p + heat)
