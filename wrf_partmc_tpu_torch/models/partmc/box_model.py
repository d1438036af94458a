"""0-D particle-resolved box model: the standalone-PartMC driver.

Port of ``wrf_partmc_tpu/models/partmc/box_model.py``.  PartMC itself is a
box model (``run_part`` over one ``aero_state``); this is that loop over one
well-mixed parcel with a time-varying environment (temperature, RH, mixing
height, photolysis zenith) and scenario forcing: emissions and dilution ->
coagulation -> MOSAIC gas and aerosol chemistry -> water equilibrium ->
rebalance, the sequence the coupled driver runs per cell
(``interface/wrf_pmc_driver.F90:169-254``).  It is the harness for the
urban-plume trajectories (Riemer, West, Zaveri & Easter, JGR 114 D09202,
2009).  The parcel is one cell ``(1, 1, 1)`` on the device of its state;
the environment is evaluated on the host each step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ...utils import rng
from .aero_data import AeroData
from .aero_state import AeroState, rebalance
from .coag import KERNEL_BROWN, coag_step
from .condense import equilib_water_hyst
from .env_state import EnvState
from .gas_data import GasData
from .mosaic import mosaic_timestep
from .scenario import Scenario, update_aero_state, update_gas_state


@dataclass
class BoxEnv:
    """Prescribed environment time functions of the parcel (the reference
    reads them from temp/height/pres profiles); each maps t [s] to a float."""
    temp: Callable          # [K]
    rel_humid: Callable     # [0-1]
    pressure: Callable      # [Pa]
    height: Callable        # mixing height [m]
    cosz: Callable          # cosine of the solar zenith angle


def make_env_state(benv: BoxEnv, t, cell_shape=(1, 1, 1), device="cpu") -> EnvState:
    f = lambda v: torch.full(cell_shape, float(v), dtype=torch.float32, device=device)
    return EnvState(temp=f(benv.temp(t)), pressure=f(benv.pressure(t)),
                    rel_humid=f(benv.rel_humid(t)), height=f(0.5 * benv.height(t)),
                    cell_volume=f(1.0),          # unit volume: num is a concentration
                    ustar=f(0.3), elapsed_time=float(np.float32(t)))


def run_box(aero: AeroState, gas, scn: Scenario, benv: BoxEnv, aero_data: AeroData,
            gas_data: GasData, mech, t_end: float, dt: float, seed: int = 0,
            n_ideal: int | None = None, n_emit_slots: int = 8,
            do_coag: bool = True, do_chem: bool = True,
            n_sub_gas: int = 6, n_sub_astem: int = 4, observer=None):
    """Run the parcel from t = 0 to ``t_end`` with macro-step ``dt`` (the
    PartMC ``run_part`` loop).  ``observer(t, aero, gas, env)``, when given,
    is called after each step.  Returns (aero, gas)."""
    base = rng.base_key(seed)
    n_ideal = n_ideal or (aero.capacity // 2)
    dev = aero.num.device
    step, t = 0, 0.0
    while t < t_end - 1e-6:
        env = make_env_state(benv, t, device=dev)
        key = lambda stream: rng.step_key(base, step, stream)
        te = env.elapsed_time
        gas = update_gas_state(scn, gas, te, dt)
        aero = update_aero_state(scn, aero, aero_data, te, dt, key(rng.STREAM_EMISSION),
                                 n_emit_slots, env.cell_volume)
        if do_coag:
            aero = coag_step(aero, aero_data, env, dt, key(rng.STREAM_COAG),
                             kernel=KERNEL_BROWN)
        if do_chem:
            cosz = torch.tensor(benv.cosz(t), dtype=torch.float32, device=dev)
            aero, gas = mosaic_timestep(mech, aero, gas, gas_data, aero_data, env, dt, cosz,
                                        n_sub_gas=n_sub_gas, n_sub_astem=n_sub_astem)
            aero = equilib_water_hyst(aero, aero_data, env)
        aero = rebalance(aero, key(rng.STREAM_REBALANCE), n_ideal, True, True)
        t += dt
        step += 1
        if observer is not None:
            observer(t, aero, gas, env)
    return aero, gas
