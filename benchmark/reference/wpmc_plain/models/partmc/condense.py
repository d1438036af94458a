"""kappa-Koehler water equilibrium, dynamic condensation and CCN activation
(port of ``wrf_partmc_tpu/models/partmc/condense.py``).

Theory: kappa-Koehler (Petters & Kreidenweis 2007, ACP 7:1961):
    S(D) = [(D^3 - Dd^3) / (D^3 - Dd^3 (1 - kappa))] * exp(A / D)
with A = 4 sigma M_w / (R T rho_w).

The reference's ``max(x, 1e-300)`` floors are ``max(x, 0)`` in float32 and
are written so here.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...utils.at import set_at
from .aero_data import AeroData, diam_to_vol, particle_volume, solute_kappa, vol_to_diam
from .aero_state import AeroState
from .env_state import EnvState


def kappa_rh_at_diam(d_wet, d_dry, kappa, A):
    """Equilibrium saturation ratio over a wet particle."""
    d3 = d_wet ** 3
    dd3 = d_dry ** 3
    aw = (d3 - dd3) / torch.clamp(d3 - dd3 * (1.0 - kappa), min=0.0)
    return aw * torch.exp(A / d_wet)


def crit_supersat(d_dry, kappa, A):
    """Critical supersaturation s_c = S_c - 1 for each dry diameter: the
    maximum of S(D), found by a fixed-iteration Newton search in
    log-diameter space (the derivative by autograd, the second derivative
    by central differences of it)."""
    kappa = torch.clamp(kappa, min=1e-12)
    d_c = torch.sqrt(3.0 * kappa * d_dry ** 3 / A)
    d_c = torch.maximum(d_c, d_dry * 1.01)

    def ln_S(ln_d):
        d = torch.exp(ln_d)
        d3 = d ** 3
        dd3 = d_dry ** 3
        aw = (d3 - dd3) / torch.clamp(d3 - dd3 * (1.0 - kappa), min=0.0)
        return torch.log(torch.clamp(aw, min=0.0)) + A / d

    def gradf(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(ln_S(x).sum(), x)
        return g

    ln_d = torch.log(d_c)
    h = 1e-3
    for _ in range(12):
        g = gradf(ln_d)
        g2 = (gradf(ln_d + h) - gradf(ln_d - h)) / (2 * h)
        step = torch.clamp(g / torch.where(torch.abs(g2) > 1e-30, g2, 1e-30), -1.0, 1.0)
        ln_d = torch.where(g2 < 0, ln_d - step, ln_d)   # only step on concave region
        ln_d = torch.maximum(ln_d, torch.log(d_dry * 1.001))
    return torch.exp(ln_S(ln_d)) - 1.0


def state_crit_supersats(state: AeroState, aero_data: AeroData, env: EnvState):
    """[..., P] critical supersaturation per particle."""
    d_dry = state.dry_diameter(aero_data)
    kap = solute_kappa(state.vol, aero_data)
    A = env.kelvin_A[..., None]
    d_dry = torch.clamp(d_dry, min=1e-10)
    return crit_supersat(d_dry, kap, A)


def equilib_water(state: AeroState, aero_data: AeroData, env: EnvState,
                  n_iter: int = 20) -> AeroState:
    """Set each particle's water volume to kappa-Koehler equilibrium with the
    ambient RH by fixed-point iteration on D from RH = a_w(D) exp(A/D):
        D_{n+1}^3 = Dd^3 * [1 + kappa * rh_eff / (1 - rh_eff)],
        rh_eff = RH * exp(-A / D_n)."""
    d_dry = torch.clamp(state.dry_diameter(aero_data), min=1e-10)
    kap = solute_kappa(state.vol, aero_data)
    return _set_equilib_water(state, aero_data, env, d_dry, kap, n_iter)


def _set_equilib_water(state, aero_data, env, d_dry, kap, n_iter):
    rh = torch.clamp(env.rel_humid[..., None], 1e-4, 0.99)
    A = env.kelvin_A[..., None]
    d = d_dry
    for _ in range(n_iter):
        rh_eff = torch.clamp(rh * torch.exp(-A / torch.maximum(d, d_dry)), 0.0, 0.9999)
        growth = 1.0 + kap * rh_eff / (1.0 - rh_eff)
        d = d_dry * torch.pow(growth, 1.0 / 3.0)
    v_wet = diam_to_vol(d)
    v_dry = particle_volume(state.vol, dry=True, aero_data=aero_data)
    v_water = torch.where(state.alive, torch.clamp(v_wet - v_dry, min=0.0), 0.0)
    vol = set_at(state.vol, aero_data.i_water, v_water, dim=-2)
    return dataclasses.replace(state, vol=vol)


# Deliquescence / crystallization RH per electrolyte-forming species
# (mutual DRH/CRH of the dominant MOSAIC salts: (NH4)2SO4 0.80/0.35,
# NH4NO3 0.618/0.25, NaCl 0.753/0.45; Tang & Munkelwitz 1994, Zaveri et
# al. 2008 MOSAIC).  Non-electrolyte species carry 0 weight.
_HYST_SPECIES = {
    "SO4": (0.80, 0.35), "NH4": (0.80, 0.35),
    "NO3": (0.618, 0.25),
    "Cl": (0.753, 0.45), "Na": (0.753, 0.45),
    "CO3": (0.80, 0.35), "Ca": (0.80, 0.35), "MSA": (0.80, 0.35),
}


def _species_table(aero_data: AeroData, values):
    return torch.tensor(values, dtype=torch.float32, device=aero_data.density.device)


def particle_drh_crh(state: AeroState, aero_data: AeroData):
    """Per-particle mixture deliquescence/crystallization RH and electrolyte
    dry-volume fraction: electrolyte-volume-weighted means of the salt-class
    DRH/CRH."""
    drh_s = _species_table(aero_data, [_HYST_SPECIES.get(n, (0.0, 0.0))[0]
                                       for n in aero_data.names])
    crh_s = _species_table(aero_data, [_HYST_SPECIES.get(n, (0.0, 0.0))[1]
                                       for n in aero_data.names])
    is_el = (drh_s > 0.0).to(torch.float32)
    dry = aero_data.dry_mask[:, None]
    v_el = torch.sum(state.vol * dry * is_el[:, None], dim=-2)
    v_dry = torch.clamp(torch.sum(state.vol * dry, dim=-2), min=0.0)
    drh = torch.sum(state.vol * dry * (drh_s * is_el)[:, None],
                    dim=-2) / torch.clamp(v_el, min=0.0)
    crh = torch.sum(state.vol * dry * (crh_s * is_el)[:, None],
                    dim=-2) / torch.clamp(v_el, min=0.0)
    return drh, crh, v_el / v_dry


def equilib_water_hyst(state: AeroState, aero_data: AeroData, env: EnvState,
                       n_iter: int = 20) -> AeroState:
    """Hysteresis-aware equilibrium water.  RH rising past the mixture DRH
    deliquesces the electrolyte (leg -> 1); RH falling below the mixture CRH
    effloresces it (leg -> 0); in between the particle stays on its current
    branch.  On the lower branch only the non-electrolyte fraction takes
    water.  Particles with a negligible electrolyte fraction have no
    hysteresis (leg pinned to 1)."""
    d_dry = torch.clamp(state.dry_diameter(aero_data), min=1e-10)
    kap = solute_kappa(state.vol, aero_data)
    drh, crh, el_frac = particle_drh_crh(state, aero_data)
    rh = env.rel_humid[..., None]
    has_hyst = el_frac > 1e-6
    one, zero = torch.ones_like(state.hyst_leg), torch.zeros_like(state.hyst_leg)
    leg = torch.where(rh >= drh, one, torch.where(rh <= crh, zero, state.hyst_leg))
    leg = torch.where(has_hyst, leg, one)
    # effloresced: electrolyte kappa suppressed, organics still hygroscopic
    dry = aero_data.dry_mask[:, None]
    is_el = _species_table(aero_data, [1.0 if n in _HYST_SPECIES else 0.0
                                       for n in aero_data.names])
    v_dry_s = state.vol * dry
    kv_org = torch.sum(v_dry_s * (aero_data.kappa * (1.0 - is_el))[:, None], dim=-2)
    kap_org = kv_org / torch.clamp(torch.sum(v_dry_s, dim=-2), min=0.0)
    kap_eff = torch.where(leg == 1, kap, kap_org)
    out = _set_equilib_water(state, aero_data, env, d_dry, kap_eff, n_iter)
    return dataclasses.replace(out, hyst_leg=leg)


def _growth_coefficient(diam, temp, pressure):
    """Maxwellian growth coefficient G [kg m-1 s-1] in
    dm/dt = 4 pi r G (S - S_eq), with transition-regime (Fukuta-Walter)
    corrected vapor diffusivity and thermal conductivity."""
    T = temp
    dv = 0.211e-4 * (T / 273.15) ** 1.94 * (101325.0 / pressure)
    ka = 2.38e-2 * (T / 296.0) ** 0.83
    r = torch.clamp(diam, min=1e-9) * 0.5
    # transition corrections (accommodation alpha=1, thermal 0.96)
    vbar = torch.sqrt(8.0 * c.UNIV_GAS_CONST * T / (torch.pi * c.WATER_MOLEC_WEIGHT))
    dv_c = dv / (1.0 + 4.0 * dv / (vbar * r))
    cbar = torch.sqrt(8.0 * c.UNIV_GAS_CONST * T / (torch.pi * c.AIR_MOLEC_WEIGHT))
    rho_air = pressure / (c.R_D * T)
    ka_c = ka / (1.0 + 4.0 * ka / (0.96 * rho_air * c.CP * cbar * r))

    es = 610.78 * torch.exp(17.27 * (T - 273.15) / (T - 35.85))
    L = c.WATER_LATENT_HEAT
    Rv = c.UNIV_GAS_CONST / c.WATER_MOLEC_WEIGHT
    term_d = Rv * T / (dv_c * es)
    term_k = (L / (ka_c * T)) * (L / (Rv * T) - 1.0)
    return 1.0 / (term_d + term_k)


def condense_dynamic(state: AeroState, aero_data: AeroData, env: EnvState,
                     dt, n_sub: int = 5, n_newton: int = 3):
    """Dynamic per-particle condensation/evaporation ODE: sub-stepped
    semi-implicit solve, every particle in every cell in lockstep.  Per
    substep each particle's water mass is advanced by damped Newton
    iterations on
        f(m) = m - m^n - h * 4 pi r(m) G (S - S_eq(m)) = 0
    with the ambient saturation S frozen at its implicit value, then S is
    updated from exact vapor-mass conservation.

    Returns (new_state, new_rel_humid [...])."""
    temp = env.temp[..., None]
    pres = env.pressure[..., None]
    V = env.cell_volume
    alive = state.alive
    d_dry = torch.clamp(state.dry_diameter(aero_data), min=1e-10)
    kap = torch.clamp(solute_kappa(state.vol, aero_data), min=1e-12)
    A = env.kelvin_A[..., None]
    v_dry = particle_volume(state.vol, dry=True, aero_data=aero_data)
    rho_w = c.WATER_DENSITY

    es = 610.78 * torch.exp(17.27 * (env.temp - 273.15) / (env.temp - 35.85))
    # vapor mass per cell [kg] at saturation ratio S=1
    Rv = c.UNIV_GAS_CONST / c.WATER_MOLEC_WEIGHT
    m_vap_sat = es / (Rv * env.temp) * V

    m_w = state.vol[..., aero_data.i_water, :] * rho_w        # [..., P]
    S = torch.clamp(env.rel_humid, 0.0, 1.1)
    h = dt / n_sub

    def s_eq(m):
        # dead slots have zero volume: clamp the wet diameter to the (already
        # floored) dry diameter so A/d stays finite, and mask the result
        d = torch.maximum(vol_to_diam(v_dry + m / rho_w), d_dry)
        return torch.where(alive, kappa_rh_at_diam(d, d_dry, kap, A), 0.0)

    def flux(m, S_cell):
        d = torch.maximum(vol_to_diam(v_dry + m / rho_w), d_dry)
        G = _growth_coefficient(d, temp, pres)
        return torch.where(alive, 2.0 * torch.pi * d * G * (S_cell[..., None] - s_eq(m)),
                           0.0)

    m_scale = rho_w * v_dry                          # dry-mass scale [kg]
    m = m_w
    for _ in range(n_sub):
        m_n = m
        # semi-implicit vapor projection: with the linearized flux
        # k_i (S - S_eq,i), solve S implicitly over the substep
        d_n = vol_to_diam(v_dry + m_n / rho_w)
        G_n = _growth_coefficient(d_n, temp, pres)
        seq_n = s_eq(m_n)
        k_i = torch.where(alive, 2.0 * torch.pi * d_n * G_n * state.num, 0.0) \
            / torch.clamp(m_vap_sat, min=1e-30)[..., None]     # [..., P] 1/s
        ksum = k_i.sum(-1)
        S_imp = (S + h * (k_i * seq_n).sum(-1)) / (1.0 + h * ksum)
        for _ in range(n_newton):
            f = m - m_n - h * flux(m, S_imp)
            dm = torch.maximum(torch.abs(m), m_scale) * 1e-3
            f2 = (m + dm) - m_n - h * flux(m + dm, S_imp)
            dfdm = torch.clamp((f2 - f) / dm, min=1.0)   # damped (stable branch)
            m = torch.clamp(m - f / dfdm, min=0.0)
        m = torch.where(alive, m, 0.0)
        # exact vapor balance: condensed water comes out of the vapor field
        dm_tot = torch.sum((m - m_n) * state.num * alive, dim=-1)   # [...] kg
        S = torch.clamp(S - dm_tot / torch.clamp(m_vap_sat, min=1e-30), min=0.0)
    vol = set_at(state.vol, aero_data.i_water, torch.where(alive, m / rho_w, 0.0),
                 dim=-2)
    return dataclasses.replace(state, vol=vol), S


def ccn_conc(state: AeroState, aero_data: AeroData, env: EnvState,
             supersats) -> torch.Tensor:
    """CCN number conc [# m-3] active at each supersaturation in ``supersats``
    [..., K]."""
    sc = state_crit_supersats(state, aero_data, env)          # [..., P]
    s = torch.as_tensor(supersats, dtype=torch.float32, device=sc.device)
    act = sc[..., None, :] <= s[..., :, None]                 # [..., K, P]
    w = state.num[..., None, :] * act
    V = env.cell_volume[..., None]
    return torch.sum(w, dim=-1) / V
