"""0-D particle-resolved box model: the coupled model's microphysics slice.

Port of ``wrf_partmc_tpu/models/partmc/box.py``: the per-cell step sequence
of ``partmc_timestep`` (``wrf_pmc_driver.F90:169-254``) -- coagulation, gas
emission and dilution, aerosol emission and dilution, optional equilibrium
water and dry deposition, then the population rebalance -- with no
transport, on any cell batch shape.  The reference's ``lax.scan`` over
steps is a plain loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...config import PartmcConfig
from ...utils import rng
from .aero_data import AeroData
from .aero_state import AeroState, rebalance
from .coag import KERNEL_BROWN, coag_step
from .condense import equilib_water
from .deposition import deposit_step
from .env_state import EnvState
from .scenario import Scenario, update_aero_state, update_gas_state


class BoxState(NamedTuple):
    aero: AeroState
    gas: torch.Tensor       # [..., G] ppb
    t: float                # elapsed time [s], a float32 value as in the reference


def box_step(box: BoxState, aero_data: AeroData, env: EnvState, scn: Scenario,
             cfg: PartmcConfig, dt, key, kernel: str = KERNEL_BROWN,
             dz=None) -> BoxState:
    """One microphysics macro-step of length ``dt`` (``partmc_chem_dt`` in
    the coupled model)."""
    aero, gas, t = box
    k_coag, k_scn, k_dep, k_reb = rng.split(key, 4)
    if cfg.do_coagulation:
        aero = coag_step(aero, aero_data, env, dt, k_coag, kernel=kernel)
    gas = update_gas_state(scn, gas, t, dt)
    if cfg.do_emission:
        aero = update_aero_state(scn, aero, aero_data, t, dt, k_scn,
                                 cfg.n_emit_slots, env.cell_volume)
    if cfg.do_condensation:
        aero = equilib_water(aero, aero_data, env)
    if cfg.do_deposition and dz is not None:
        aero = deposit_step(aero, aero_data, env, dt, dz, k_dep)
    aero = rebalance(aero, k_reb, cfg.num_particles, allow_halving=cfg.allow_halving,
                     allow_doubling=cfg.allow_doubling)
    return BoxState(aero=aero, gas=gas, t=float(np.float32(t) + np.float32(dt)))


def run_box(box: BoxState, aero_data: AeroData, env: EnvState, scn: Scenario,
            cfg: PartmcConfig, dt, n_steps: int, seed: int = 0,
            kernel: str = KERNEL_BROWN, dz=None) -> BoxState:
    """``n_steps`` box steps, step i keyed by ``rng.step_key(seed, i,
    STREAM_COAG)`` as the reference's scan keys them."""
    key0 = rng.base_key(seed)
    for i in range(n_steps):
        box = box_step(box, aero_data, env, scn, cfg, dt,
                       rng.step_key(key0, i, rng.STREAM_COAG), kernel=kernel, dz=dz)
    return box
