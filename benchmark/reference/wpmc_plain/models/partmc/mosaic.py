"""MOSAIC-equivalent aerosol chemistry: CBM-Z gas phase + ASTEM-style
dynamic gas-particle mass transfer + MESA-lite inorganic thermodynamics +
absorptive SOA partitioning (port of
``wrf_partmc_tpu/models/partmc/mosaic.py``).

Everything is fixed-shape ``[..., P]`` tensors masked by ``alive``;
gas<->particle exchange is exactly mass-conserving by construction (final
gas = initial gas - sum of clamped particle increments).  The transfer
chains keep the reference's float32 order of operations: folding their
unit-conversion factors into the uptake-kernel prefactors underflows.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...utils.at import add_at
from .aero_data import AeroData
from .aero_state import AeroState
from .cbmz import Mechanism, cbmz_step
from .env_state import EnvState
from .gas_data import GasData

# ---------------------------------------------------------------------------
# volatile pairs: (gas name, aerosol species name, gas diffusivity m2/s)
# ---------------------------------------------------------------------------
NONVOLATILE = (("H2SO4", "SO4", 9.0e-6), ("MSA", "MSA", 9.0e-6),
               ("SULFHOX", "SO4", 9.0e-6))
SEMIVOLATILE = (("HNO3", "NO3", 1.2e-5), ("HCl", "Cl", 1.5e-5),
                ("NH3", "NH4", 2.0e-5))
# SOA two-product saturation concentrations C* at 298 K [ug/m3] and
# vaporization enthalpy [J/mol] (SORGAM/CACM-class values)
SOA_SPECIES = (("ARO1", 0.5), ("ARO2", 20.0), ("ALK1", 0.5), ("OLE1", 0.5),
               ("API1", 2.0), ("API2", 50.0), ("LIM1", 1.0), ("LIM2", 25.0))
SOA_DHVAP = 42.0e3


def _uptake_kernel(diam, temp, pressure, diff_gas, mw_gas, accom=0.1):
    """Fuchs-Sutugin transition-regime uptake coefficient k = 2 pi D d f
    [m3/s per physical particle]."""
    speed = torch.sqrt(8.0 * c.UNIV_GAS_CONST * temp / (torch.pi * mw_gas))
    mfp = 3.0 * diff_gas / speed
    kn = 2.0 * mfp / diam
    f = (0.75 * accom * (1.0 + kn)
         / (kn * kn + kn + 0.283 * kn * accom + 0.75 * accom))
    return 2.0 * torch.pi * diff_gas * diam * f


def _ppb_to_mol_m3(ppb, temp, pressure):
    return ppb * 1e-9 * pressure / (c.UNIV_GAS_CONST * temp)


def _mol_m3_to_ppb(n, temp, pressure):
    return n * 1e9 * c.UNIV_GAS_CONST * temp / pressure


def _mol_of(vol, ad: AeroData, name: str):
    """Per-particle mol of one species [..., P] (per physical particle)."""
    s = ad.spec_by_name(name)
    return vol[..., s, :] * ad.density[s] / ad.molec_weight[s]


def particle_ion_balance(aero: AeroState, ad: AeroData):
    """MESA-lite electro-neutrality bookkeeping [..., P] (mol equivalents):
    returns (anion_equiv, cation_equiv, nh4_mol)."""
    m = lambda name: _mol_of(aero.vol, ad, name)
    so4, no3, cl, msa, co3 = m("SO4"), m("NO3"), m("Cl"), m("MSA"), m("CO3")
    nh4, na, ca = m("NH4"), m("Na"), m("Ca")
    anion = 2.0 * so4 + no3 + cl + msa + 2.0 * co3
    cation = nh4 + na + 2.0 * ca
    return anion, cation, nh4


def kp_nh4no3(temp):
    """NH4NO3(s) <-> NH3 + HNO3 dissociation constant [ppb^2]
    (Mozurkewich 1993 solid-phase fit)."""
    lnkp = 118.87 - 24084.0 / temp - 6.025 * torch.log(temp)
    return torch.exp(lnkp)


def kp_nh4cl(temp):
    """NH4Cl(s) <-> NH3 + HCl [ppb^2] (re-derived fit, ~100 ppb^2 at 298 K)."""
    return 4.6e33 * torch.exp(-21725.0 / temp)


def kp_nh4no3_aq(temp, aw):
    """Activity-corrected aqueous NH4NO3 dissociation product [ppb^2]
    (Mozurkewich 1993; Seinfeld & Pandis eq. 10.98-10.100), used on the
    deliquesced hysteresis leg:

        Kp_aq = (P1 - P2 (1-aw) + P3 (1-aw)^2) (1-aw)^1.75 Kp_solid
    """
    aw = torch.clamp(aw, 0.10, 0.98)
    lnT = torch.log(temp)
    p1 = torch.exp(-135.94 + 8763.0 / temp + 19.12 * lnT)
    p2 = torch.exp(-122.65 + 9969.0 / temp + 16.22 * lnT)
    p3 = torch.exp(-182.61 + 13875.0 / temp + 24.46 * lnT)
    x = 1.0 - aw
    return (p1 - p2 * x + p3 * x * x) * x ** 1.75 * kp_nh4no3(temp)


def astem_inorganic(aero: AeroState, gas_ppb, gas_data: GasData,
                    ad: AeroData, env: EnvState, dt, n_sub: int = 4,
                    tau_evap: float = 300.0):
    """Semi-implicit dynamic mass transfer of the inorganic gases.

    Vectorized ASTEM analogue: for each volatile gas g,
      Cg' = (Cg + h sum_i K_i Ceq_i) / (1 + h sum_i K_i),
      dm_i = K_i (Cg' - Ceq_i) h  (clamped; gas closed by exact balance),
    with K_i = k_i n_i / V and Ceq from MESA-lite gating + Kp.
    """
    temp = env.temp[..., None]
    pres = env.pressure[..., None]
    V = env.cell_volume[..., None]
    diam = torch.clamp(aero.wet_diameter(), min=1e-9)
    alive = aero.alive
    kelvin = torch.exp(env.kelvin_A[..., None] / diam)
    h = dt / n_sub

    i_gas = {g: gas_data.spec_by_name(g) for g, _, _ in NONVOLATILE + SEMIVOLATILE}
    s_aer = {a: ad.spec_by_name(a) for _, a, _ in NONVOLATILE + SEMIVOLATILE}
    num = torch.where(alive, aero.num, 0.0)

    def transfer(gas, vol, g_name, a_name, diff, ceq_ppb, evap_extra=None):
        ig, sa = i_gas[g_name], s_aer[a_name]
        mw_g = gas_data.molec_weight[ig]
        mw_a = ad.molec_weight[sa]
        k_phys = _uptake_kernel(diam, temp, pres, diff, mw_g)   # per PHYS
        K = (torch.where(alive, k_phys * aero.num, 0.0)
             / torch.clamp(V, min=1e-30))                        # [...,P] 1/s
        Ksum = K.sum(-1)
        cg = gas[..., ig]
        src = (K * ceq_ppb).sum(-1)
        cg_new = (cg + h * src) / (1.0 + h * Ksum)
        # per-particle mol increment (per physical particle)
        dn = (torch.where(alive, k_phys, 0.0)
              * _ppb_to_mol_m3(cg_new[..., None] - ceq_ppb, temp, pres)
              * h)
        # clamp evaporation to available mass
        avail = vol[..., sa, :] * ad.density[sa] / mw_a
        dn = torch.maximum(dn, -avail)
        if evap_extra is not None:
            dn = dn - torch.minimum(evap_extra, avail + dn)
        # gas-positivity guard: when evaporation was clamped, scale back
        # condensation so total uptake <= gas present + actual release
        pos = torch.where(dn > 0.0, dn * num, 0.0).sum(-1) / torch.clamp(
            V[..., 0], min=1e-30)                               # mol/m3 uptake
        neg = torch.where(dn < 0.0, dn * num, 0.0).sum(-1) / torch.clamp(
            V[..., 0], min=1e-30)                               # mol/m3 release
        cg_mol = _ppb_to_mol_m3(cg, temp[..., 0], pres[..., 0])
        scale = torch.clamp((cg_mol - neg) / torch.clamp(pos, min=1e-30), max=1.0)
        dn = torch.where(dn > 0.0, dn * scale[..., None], dn)
        vol = add_at(vol, sa, torch.where(alive, dn * mw_a / ad.density[sa], 0.0),
                     dim=-2)
        # exact gas balance: ppb change = - sum_i dn_i n_i / V
        dgas = (torch.where(alive, dn * aero.num, 0.0).sum(-1)
                / torch.clamp(V[..., 0], min=1e-30))
        gas = add_at(gas, ig, -_mol_m3_to_ppb(dgas, temp[..., 0], pres[..., 0]))
        return gas, vol

    rh_p = env.rel_humid[..., None]
    kp_no3 = torch.where(aero.hyst_leg == 1, kp_nh4no3_aq(temp, rh_p),
                         kp_nh4no3(temp))
    kp_cl = kp_nh4cl(temp)
    zero = torch.zeros_like(diam)
    vol, gas = aero.vol, gas_ppb.to(torch.float32)
    for _ in range(n_sub):
        anion, cation, nh4 = particle_ion_balance(
            dataclasses.replace(aero, vol=vol), ad)
        acid_excess = anion - cation                     # >0: acidic
        acidic = acid_excess > 0.0
        # sea-salt/dust cation surplus before NH4 (drives HNO3/HCl uptake)
        salt_capacity = (cation - nh4) - anion            # >0: alkaline salts

        # non-volatile acids: Ceq = 0
        for g_name, a_name, diff in NONVOLATILE:
            gas, vol = transfer(gas, vol, g_name, a_name, diff, zero)

        # HNO3 / HCl: salt-capacity particles take up freely; neutralized
        # particles sit at the NH4NO3/NH4Cl Kp equilibrium (aqueous Kp on
        # the deliquesced leg, solid Kp on the effloresced one); acidic
        # particles see zero net flux plus explicit release of the
        # un-neutralized volatile anions on tau_evap
        cg_nh3 = torch.clamp(gas[..., i_gas["NH3"]], min=1e-6)[..., None]
        no3 = _mol_of(vol, ad, "NO3")
        cl = _mol_of(vol, ad, "Cl")
        vol_anions = no3 + cl
        release_tot = torch.minimum(torch.clamp(acid_excess, min=0.0), vol_anions)
        for g_name, a_name, diff, kp, rel in (
                ("HNO3", "NO3", 1.2e-5, kp_no3,
                 release_tot * no3 / torch.clamp(vol_anions, min=1e-30)),
                ("HCl", "Cl", 1.5e-5, kp_cl,
                 release_tot * cl / torch.clamp(vol_anions, min=1e-30))):
            ceq_neutral = kp / cg_nh3 * kelvin
            cg_here = torch.broadcast_to(gas[..., i_gas[g_name], None], diam.shape)
            ceq = torch.where(salt_capacity > 0.0, 0.0,
                              torch.where(acidic, cg_here, ceq_neutral))
            ceq = torch.where(alive, ceq, 0.0)
            gas, vol = transfer(gas, vol, g_name, a_name, diff, ceq,
                                evap_extra=torch.where(alive & acidic, rel, 0.0)
                                * (h / tau_evap))

        # NH3: uptake onto acidic particles (Ceq=0); non-acidic particles sit
        # at zero net flux (Ceq=Cg) with excess NH4 released on tau_evap
        ceq_nh3 = torch.where(alive & acidic, 0.0, torch.broadcast_to(
            gas[..., i_gas["NH3"], None], diam.shape))
        nh4_excess = torch.clamp(-acid_excess, min=0.0)   # mol over neutral
        evap_extra = torch.where(alive, nh4_excess, 0.0) * (h / tau_evap)
        gas, vol = transfer(gas, vol, "NH3", "NH4", 2.0e-5, ceq_nh3,
                            evap_extra=evap_extra)
    # f32 full-evaporation clamps can leave -eps volumes; keep them exactly 0
    # so downstream cube roots (wet_diameter) stay finite
    return dataclasses.replace(aero, vol=torch.clamp(vol, min=0.0)), gas


def soa_partition(aero: AeroState, gas_ppb, gas_data: GasData, ad: AeroData,
                  env: EnvState, dt, n_iter: int = 8,
                  tau_cond: float = 600.0):
    """Pankow absorptive partitioning of the 8 SOA products, relaxed toward
    equilibrium on a tau_cond timescale (per cell), distributed per particle
    by uptake kernel (cond.) / current loading (evap.)."""
    temp, pres, V = env.temp, env.pressure, env.cell_volume
    alive = aero.alive
    diam = torch.clamp(aero.wet_diameter(), min=1e-9)
    vol = aero.vol
    gas = gas_ppb.to(torch.float32)
    s_oc = ad.spec_by_name("OC")

    def aer_ugm3(v, s):
        m = v[..., s, :] * ad.density[s] * aero.num            # kg per slot
        return torch.where(alive, m, 0.0).sum(-1) / torch.clamp(V, min=1e-30) * 1e9

    idx_g = [gas_data.spec_by_name(n) for n, _ in SOA_SPECIES]
    idx_a = [ad.spec_by_name(n) for n, _ in SOA_SPECIES]
    cstar = [cs * torch.exp(SOA_DHVAP / c.UNIV_GAS_CONST
                            * (1.0 / 298.0 - 1.0 / temp)) * (298.0 / temp)
             for _, cs in SOA_SPECIES]

    def g2u(ppb, ig):             # gas ppb -> ug/m3
        return _ppb_to_mol_m3(ppb, temp, pres) * gas_data.molec_weight[ig] * 1e9

    def u2g(u, ig):
        return _mol_m3_to_ppb(u * 1e-9 / gas_data.molec_weight[ig], temp, pres)

    aer_now = [aer_ugm3(vol, s) for s in idx_a]
    gas_u = [g2u(gas[..., ig], ig) for ig in idx_g]
    ctot = [a + g for a, g in zip(aer_now, gas_u)]
    m_oc = aer_ugm3(vol, s_oc)

    # fixed point for the absorbing organic mass
    m_o = m_oc + sum(aer_now)
    for _ in range(n_iter):
        aer_eq = [ct * m_o / torch.clamp(m_o + cs, min=1e-10)
                  for ct, cs in zip(ctot, cstar)]
        m_o = torch.clamp(m_oc + sum(aer_eq), min=1e-6)

    relax = float(1.0 - torch.exp(torch.tensor(-dt / tau_cond, dtype=torch.float32)))
    k_i = torch.where(alive, _uptake_kernel(
        diam, temp[..., None], pres[..., None], 5.0e-6, 0.15) * aero.num, 0.0)
    k_frac = k_i / torch.clamp(k_i.sum(-1, keepdim=True), min=1e-30)

    for ig, sa, aeq, anow in zip(idx_g, idx_a, aer_eq, aer_now):
        delta = (aeq - anow) * relax        # ug/m3 to move
        # condensation: distribute by kernel; evaporation: by current mass
        m_part = torch.where(alive, vol[..., sa, :] * ad.density[sa], 0.0)
        m_frac = m_part * aero.num / torch.clamp(
            (m_part * aero.num).sum(-1, keepdim=True), min=1e-30)
        frac = torch.where(delta[..., None] >= 0.0, k_frac, m_frac)
        dm = (delta[..., None] * frac * 1e-9 * V[..., None]
              / torch.clamp(aero.num, min=1e-30))          # kg per phys
        dm = torch.maximum(dm, -m_part / torch.clamp(aero.num, min=1e-30))
        vol = add_at(vol, sa, torch.where(alive, dm / ad.density[sa], 0.0), dim=-2)
        moved = (torch.where(alive, dm * aero.num, 0.0).sum(-1)
                 / torch.clamp(V, min=1e-30) * 1e9)         # ug/m3 actually
        gas = add_at(gas, ig, -u2g(moved, ig))
    return dataclasses.replace(aero, vol=torch.clamp(vol, min=0.0)), gas


def mosaic_timestep(mech: Mechanism, aero: AeroState, gas_ppb,
                    gas_data: GasData, ad: AeroData, env: EnvState,
                    dt, cosz, do_gas: bool = True,
                    n_sub_gas: int = 6, n_sub_astem: int = 4, j_scale=None):
    """Full MOSAIC-equivalent chemistry macro-step (the reference's
    ``mosaic_timestep`` coupling surface): CBM-Z gas photochemistry, then
    ASTEM inorganic transfer, then SOA partitioning.  Water equilibrium is
    composed by the caller (driver).  ``j_scale``: per-cell aerosol
    attenuation of the actinic flux
    (``physics.radiation.photolysis_aerosol_factor``)."""
    gas = gas_ppb.to(torch.float32)
    if do_gas:
        gas = cbmz_step(mech, gas, env.temp, env.pressure, env.rel_humid,
                        cosz, dt, n_sub=n_sub_gas, j_scale=j_scale)
    aero, gas = astem_inorganic(aero, gas, gas_data, ad, env, dt,
                                n_sub=n_sub_astem)
    aero, gas = soa_partition(aero, gas, gas_data, ad, env, dt)
    return aero, torch.clamp(gas, min=0.0)
