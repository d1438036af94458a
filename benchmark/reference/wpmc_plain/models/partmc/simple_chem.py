"""Reduced gas chemistry + gas-particle mass transfer, the ``chem_mech ==
"simple"`` stand-in for MOSAIC (port of
``wrf_partmc_tpu/models/partmc/simple_chem.py``):

* SO2 + OH -> H2SO4 (pseudo-first-order with prescribed [OH]),
* kinetic H2SO4 condensation onto the particle population (Fuchs-Sutugin
  transition regime), mass distributed per particle in proportion to its
  condensation kernel,
* NH3 neutralization of condensed sulfate (up to 2:1 molar).
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...utils.at import add_at
from .aero_data import AeroData
from .aero_state import AeroState
from .env_state import EnvState
from .gas_data import GasData

OH_CONC = 2.0e12          # molecules m-3 (daytime-ish prescribed oxidant)
K_SO2_OH = 1.5e-18        # m3 molecule-1 s-1 (effective 2nd-order rate)
ACCOM = 0.65              # H2SO4 mass accommodation


def _ppb_to_molec_m3(ppb, temp, pressure):
    return ppb * 1e-9 * pressure / (c.BOLTZMANN * temp)


def _molec_m3_to_ppb(n, temp, pressure):
    return n * 1e9 * c.BOLTZMANN * temp / pressure


def condensation_kernel(diam, diff_gas=9.0e-6, molec_speed=243.0):
    """Per-particle condensational uptake coefficient k_i [m3 s-1]
    (Fuchs-Sutugin transition regime): k = 2 pi D d f(Kn, alpha)."""
    mfp = 3.0 * diff_gas / molec_speed
    kn = 2.0 * mfp / diam
    f = (0.75 * ACCOM * (1.0 + kn)
         / (kn * kn + kn + 0.283 * kn * ACCOM + 0.75 * ACCOM))
    return 2.0 * torch.pi * diff_gas * diam * f


def chem_step(aero: AeroState, gas, gas_data: GasData, aero_data: AeroData,
              env: EnvState, dt) -> tuple[AeroState, torch.Tensor]:
    """One chemistry macro-step (mosaic_timestep coupling surface).
    gas: [..., G] ppb over the aerosol's cell shape."""
    i_so2 = gas_data.spec_by_name("SO2")
    i_h2so4 = gas_data.spec_by_name("H2SO4")
    i_nh3 = gas_data.spec_by_name("NH3")
    s_so4 = aero_data.spec_by_name("SO4")
    s_nh4 = aero_data.spec_by_name("NH4")
    temp, pres, V = env.temp, env.pressure, env.cell_volume

    # (1) gas phase: SO2 + OH -> H2SO4
    k1 = K_SO2_OH * OH_CONC
    d_so2 = gas[..., i_so2] * float(1.0 - torch.exp(torch.tensor(-k1 * dt, dtype=torch.float32)))
    gas = add_at(gas, i_so2, -d_so2)
    gas = add_at(gas, i_h2so4, d_so2)

    # (2) kinetic H2SO4 condensation onto the population
    diam = torch.clamp(aero.wet_diameter(), min=1e-9)
    k_i = condensation_kernel(diam) * aero.num                 # [..., P] m3/s
    k_tot = torch.sum(torch.where(aero.alive, k_i, 0.0), dim=-1)
    n_h2so4 = _ppb_to_molec_m3(gas[..., i_h2so4], temp, pres)  # molec m-3
    lam = k_tot / torch.clamp(V, min=1e-30)                     # s-1
    transferred = n_h2so4 * (1.0 - torch.exp(-lam * dt))        # molec m-3
    gas = add_at(gas, i_h2so4, -_molec_m3_to_ppb(transferred, temp, pres))
    # distribute condensed mass per particle proportional to k_i
    frac = torch.where(aero.alive, k_i, 0.0) / torch.clamp(k_tot, min=1e-30)[..., None]
    molec_per_part = transferred[..., None] * V[..., None] * frac
    mass_per_phys = (molec_per_part / c.AVOGADRO * 0.098       # kg (98 g/mol)
                     / torch.clamp(aero.num, min=1e-30))
    dvol = mass_per_phys / aero_data.density[s_so4]
    vol = add_at(aero.vol, s_so4, torch.where(aero.alive, dvol, 0.0), dim=-2)

    # (3) NH3 neutralization: up to 2 NH4 per newly condensed SO4
    mol_so4_new = mass_per_phys / 0.098                        # mol per phys part
    nh3_avail = _ppb_to_molec_m3(gas[..., i_nh3], temp, pres) / c.AVOGADRO  # mol m-3
    want = 2.0 * torch.sum(torch.where(aero.alive, mol_so4_new * aero.num, 0.0),
                           dim=-1) / torch.clamp(V, min=1e-30)  # mol m-3
    take = torch.minimum(want, nh3_avail)
    ratio = take / torch.clamp(want, min=1e-30)
    mass_nh4 = mol_so4_new * 2.0 * ratio[..., None] * 0.018    # kg per phys part
    vol = add_at(vol, s_nh4,
                 torch.where(aero.alive, mass_nh4 / aero_data.density[s_nh4], 0.0),
                 dim=-2)
    gas = add_at(gas, i_nh3, -_molec_m3_to_ppb(take * c.AVOGADRO, temp, pres))
    return dataclasses.replace(aero, vol=vol), gas
