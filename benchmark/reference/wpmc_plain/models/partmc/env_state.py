"""Per-cell scalar environment (port of
``wrf_partmc_tpu/models/partmc/env_state.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import constants as c


@dataclass(frozen=True)
class EnvState:
    temp: torch.Tensor           # [K]
    pressure: torch.Tensor       # [Pa]
    rel_humid: torch.Tensor      # [0-1]
    height: torch.Tensor         # cell-center height [m]
    cell_volume: torch.Tensor    # [m3]
    ustar: torch.Tensor          # friction velocity [m s-1]
    elapsed_time: float          # [s]

    @property
    def air_density(self) -> torch.Tensor:
        return self.pressure / (c.R_D * self.temp)

    @property
    def air_mean_free_path(self) -> torch.Tensor:
        """Mean free path of air molecules [m]."""
        return (2.0 * c.AIR_DYN_VISC
                / (self.pressure * torch.sqrt(8.0 * c.AIR_MOLEC_WEIGHT
                                              / (torch.pi * c.UNIV_GAS_CONST * self.temp))))

    @property
    def kelvin_A(self) -> torch.Tensor:
        """Kelvin coefficient A [m] in exp(A/D) of the Koehler equation."""
        return (4.0 * c.WATER_MOLEC_WEIGHT * c.WATER_SURF_ENERGY
                / (c.UNIV_GAS_CONST * self.temp * c.WATER_DENSITY))


def make_env_state(temp=298.15, pressure=1.0e5, rel_humid=0.5, height=50.0,
                   cell_volume=1.0, ustar=0.3, elapsed_time=0.0,
                   cell_shape=(), device="cuda") -> EnvState:
    """An EnvState of constant float32 fields over ``cell_shape``, the
    relative humidity clipped to [0.001, 0.95].  ``elapsed_time`` is a float
    (rounded to float32), as the coupled step's EnvState holds it."""
    full = lambda v: torch.full(cell_shape, float(v), dtype=torch.float32, device=device)
    return EnvState(temp=full(temp), pressure=full(pressure),
                    rel_humid=torch.clamp(full(rel_humid), 0.001, 0.95),
                    height=full(height), cell_volume=full(cell_volume),
                    ustar=full(ustar), elapsed_time=float(np.float32(elapsed_time)))
