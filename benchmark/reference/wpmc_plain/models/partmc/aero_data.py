"""Aerosol species table (port of ``wrf_partmc_tpu/models/partmc/aero_data.py``).

Particle tensors are laid out ``vol: [..., S, P]`` and ``num/...: [..., P]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# (name, density [kg/m3], num_ions, molec weight [kg/mol], kappa)
# Standard PartMC-MOSAIC 20-species set; property values from the open
# literature (Zaveri et al. 2008 MOSAIC; Petters & Kreidenweis 2007 kappas).
DEFAULT_SPECIES = (
    ("SO4",  1800.0, 0, 96.0e-3,  0.65),
    ("NO3",  1800.0, 0, 62.0e-3,  0.65),
    ("Cl",   2200.0, 0, 35.5e-3,  1.1),
    ("NH4",  1800.0, 0, 18.0e-3,  0.65),
    ("MSA",  1800.0, 0, 95.0e-3,  0.53),
    ("ARO1", 1400.0, 0, 150.0e-3, 0.1),
    ("ARO2", 1400.0, 0, 150.0e-3, 0.1),
    ("ALK1", 1400.0, 0, 140.0e-3, 0.1),
    ("OLE1", 1400.0, 0, 140.0e-3, 0.1),
    ("API1", 1400.0, 0, 184.0e-3, 0.1),
    ("API2", 1400.0, 0, 184.0e-3, 0.1),
    ("LIM1", 1400.0, 0, 200.0e-3, 0.1),
    ("LIM2", 1400.0, 0, 200.0e-3, 0.1),
    ("CO3",  2600.0, 0, 60.0e-3,  0.53),
    ("Na",   2200.0, 0, 23.0e-3,  1.1),
    ("Ca",   2600.0, 0, 40.0e-3,  0.53),
    ("OIN",  2600.0, 0, 1.0e-3,   0.1),
    ("OC",   1000.0, 0, 1.0e-3,   0.001),
    ("BC",   1800.0, 0, 1.0e-3,   0.0),
    ("H2O",  1000.0, 0, 18.0e-3,  0.0),
)


@dataclass(frozen=True)
class AeroData:
    """Species property table."""

    density: torch.Tensor          # [S] kg m-3
    num_ions: torch.Tensor         # [S]
    molec_weight: torch.Tensor     # [S] kg mol-1
    kappa: torch.Tensor            # [S] hygroscopicity
    names: tuple = ()
    sources: tuple = ()
    weight_classes: tuple = ()

    @property
    def n_spec(self) -> int:
        return len(self.names)

    @property
    def i_water(self) -> int:
        return self.names.index("H2O")

    def spec_by_name(self, name: str) -> int:
        return self.names.index(name)

    @property
    def dry_mask(self) -> torch.Tensor:
        """[S] 1.0 for every species except water (for dry diameter/mass)."""
        m = torch.ones(self.n_spec, dtype=torch.float32, device=self.density.device)
        m[self.i_water] = 0.0
        return m


def make_aero_data(species=DEFAULT_SPECIES, device="cpu") -> AeroData:
    names = tuple(s[0] for s in species)
    f32 = lambda i: torch.as_tensor(np.asarray([s[i] for s in species],
                                               np.float32), device=device)
    return AeroData(density=f32(1), num_ions=f32(2), molec_weight=f32(3),
                    kappa=f32(4), names=names)


def parse_aero_data_dat(text: str, device="cpu") -> AeroData:
    """Parse PartMC's ``aero_data.dat`` spec-file format: '#' comments,
    rows of ``name density num_ions molec_weight kappa``."""
    rows = []
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line:
            continue
        parts = line.split()
        rows.append((parts[0], float(parts[1]), int(float(parts[2])),
                     float(parts[3]), float(parts[4])))
    if not rows:
        raise ValueError("no species rows found")
    return make_aero_data(tuple(rows), device=device)


def particle_volume(vol, dry: bool = False, aero_data: AeroData | None = None):
    """Total per-particle volume [..., P] from [..., S, P] composition."""
    if dry:
        return torch.sum(vol * aero_data.dry_mask[:, None], dim=-2)
    return torch.sum(vol, dim=-2)


def particle_mass(vol, aero_data: AeroData, dry: bool = False):
    rho = aero_data.density[:, None]
    if dry:
        rho = rho * aero_data.dry_mask[:, None]
    return torch.sum(vol * rho, dim=-2)


def vol_to_diam(v):
    """Spherical volume -> diameter."""
    return torch.pow(6.0 * v / torch.pi, 1.0 / 3.0)


def diam_to_vol(d):
    return (torch.pi / 6.0) * (d * d * d)


def particle_density(vol, aero_data: AeroData):
    """Mean density of each particle [..., P] (a dead slot's 0/0 is NaN, as
    in the reference, whose 1e-300 floor is 0 in float32)."""
    v = particle_volume(vol)
    m = particle_mass(vol, aero_data)
    return m / torch.clamp(v, min=0.0)


def solute_kappa(vol, aero_data: AeroData):
    """Volume-weighted mean hygroscopicity over dry species [..., P]
    (kappa-Koehler mixing rule, Petters & Kreidenweis 2007)."""
    dry = aero_data.dry_mask[:, None]
    vd = torch.sum(vol * dry, dim=-2)
    kv = torch.sum(vol * dry * aero_data.kappa[:, None], dim=-2)
    return kv / torch.clamp(vd, min=0.0)
