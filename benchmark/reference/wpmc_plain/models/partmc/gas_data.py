"""Gas species registry (port of ``make_gas_data`` of
``wrf_partmc_tpu/models/partmc/gas_data.py``).  A gas state is a [..., G]
tensor of mix ratios in ppb."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# A representative subset of the CBM-Z gas list (full MOSAIC runs carry 77);
# molecular weights in kg/mol.
DEFAULT_GASES = (
    ("H2SO4", 98.0e-3), ("HNO3", 63.0e-3), ("HCl", 36.5e-3), ("NH3", 17.0e-3),
    ("NO", 30.0e-3), ("NO2", 46.0e-3), ("NO3", 62.0e-3), ("N2O5", 108.0e-3),
    ("HONO", 47.0e-3), ("HNO4", 79.0e-3), ("O3", 48.0e-3), ("O1D", 16.0e-3),
    ("O3P", 16.0e-3), ("OH", 17.0e-3), ("HO2", 33.0e-3), ("H2O2", 34.0e-3),
    ("CO", 28.0e-3), ("SO2", 64.0e-3), ("CH4", 16.0e-3), ("C2H6", 30.0e-3),
    ("CH3O2", 47.0e-3), ("ETHP", 61.0e-3), ("HCHO", 30.0e-3), ("CH3OH", 32.0e-3),
    ("ANOL", 46.0e-3), ("CH3OOH", 48.0e-3), ("ETHOOH", 62.0e-3), ("ALD2", 44.0e-3),
    ("HCOOH", 46.0e-3), ("RCOOH", 60.0e-3), ("C2O3", 75.0e-3), ("PAN", 121.0e-3),
)


@dataclass(frozen=True)
class GasData:
    molec_weight: torch.Tensor   # [G] kg mol-1
    names: tuple = ()

    @property
    def n_spec(self) -> int:
        return len(self.names)

    def spec_by_name(self, name: str) -> int:
        return self.names.index(name)


def make_gas_data(gases=DEFAULT_GASES, device="cpu") -> GasData:
    return GasData(molec_weight=torch.as_tensor(
        np.asarray([g[1] for g in gases], np.float32), device=device),
        names=tuple(g[0] for g in gases))


def make_gas_data_cbmz(device="cpu") -> GasData:
    """The full 77-species CBM-Z registry of the chem_opt==777 package
    (``Registry/registry.chem:3986``), for ``models.partmc.cbmz``."""
    from .cbmz import CBMZ_GASES
    return make_gas_data(CBMZ_GASES, device=device)


def parse_gas_data_dat(text: str, device="cpu") -> GasData:
    """Parse PartMC's ``gas_data.dat`` format: '#' comments, rows of
    ``name molec_weight`` (1e-3 kg/mol where the weight is left out)."""
    rows = []
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line:
            continue
        p = line.split()
        rows.append((p[0], float(p[1]) if len(p) > 1 else 1.0e-3))
    return make_gas_data(tuple(rows), device=device)


def zero_gas_state(gas_data: GasData, cell_shape=(), device="cpu") -> torch.Tensor:
    """Mix ratios [ppb], zeros of shape [*cell_shape, G]."""
    return torch.zeros((*cell_shape, gas_data.n_spec), dtype=torch.float32, device=device)
