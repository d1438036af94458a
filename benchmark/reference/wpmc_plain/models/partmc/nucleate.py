"""H2SO4 -> new-particle nucleation (port of
``wrf_partmc_tpu/models/partmc/nucleate.py``).

Sulfuric-acid power-law nucleation (Kuang et al. 2008 activation form):
J = K [H2SO4]^2 [# m-3 s-1], new particles created at d_init with pure-SO4
composition; the consumed H2SO4 gas is removed.
"""

from __future__ import annotations

import torch

from ... import constants as c
from ...utils.at import add_at, set_at
from .aero_data import AeroData, diam_to_vol
from .aero_state import AeroState, add_particles
from .gas_data import GasData

NUCLEATE_COEF = 1.0e-18      # K [m3 s-1] (activation-type prefactor)
D_INIT = 1.0e-9              # initial particle diameter [m]


def h2so4_conc_from_ppb(ppb, temp, pressure):
    """molecules m-3 from ppb mixing ratio."""
    n_air = pressure / (c.BOLTZMANN * temp)
    return ppb * 1e-9 * n_air


def nucleate_step(aero: AeroState, gas, gas_data: GasData,
                  aero_data: AeroData, temp, pressure, cell_volume, dt,
                  n_slots: int = 2, source: int = 0, w_class: int = 0):
    """One nucleation step.  gas: [..., G] ppb.  Returns (aero, gas)."""
    ig = gas_data.spec_by_name("H2SO4")
    conc = h2so4_conc_from_ppb(gas[..., ig], temp, pressure)     # [cells]
    J = NUCLEATE_COEF * conc * conc                              # [# m-3 s-1]
    n_new = J * dt * cell_volume                                 # [cells]
    cell_shape = aero.cell_shape
    E = n_slots
    dev = gas.device
    pvol = diam_to_vol(torch.full((), D_INIT, dtype=torch.float32, device=dev))
    i_so4 = aero_data.spec_by_name("SO4")
    vol = set_at(torch.zeros((*cell_shape, aero_data.n_spec, E), dtype=torch.float32,
                             device=dev), i_so4, pvol, dim=-2)
    num = (n_new / E)[..., None].expand(*cell_shape, E).to(torch.float32)
    src = torch.full((*cell_shape, E), source, dtype=torch.int32, device=dev)
    wcl = torch.full((*cell_shape, E), w_class, dtype=torch.int32, device=dev)
    aero = add_particles(aero, vol, num, src, wcl)
    # consume the nucleated sulfate mass from the gas phase
    mass_new = n_new * pvol * aero_data.density[i_so4]           # kg per cell
    mol_new = mass_new / aero_data.molec_weight[i_so4]           # mol
    n_air_mol = pressure * cell_volume / (c.UNIV_GAS_CONST * temp)
    d_ppb = 1e9 * mol_new / torch.clamp(n_air_mol, min=1e-30)
    gas = add_at(gas, ig, -torch.minimum(d_ppb, gas[..., ig]))
    return aero, gas
