"""Per-cell scalar environment (port of
``wrf_partmc_tpu/models/partmc/env_state.py``)."""

from __future__ import annotations

from dataclasses import dataclass

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
