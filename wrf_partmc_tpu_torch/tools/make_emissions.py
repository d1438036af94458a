"""SMOKE + JSON-speciation emissions ingestion (make_emissions).

Port of ``wrf_partmc_tpu/tools/make_emissions.py``.  The reference's
``emissions/make_emissions.F90`` converts source-apportioned SMOKE
inventory output plus a JSON source-speciation table
(``emissions/emissions.json``: per source_name a source_class, a
weight_class, and log-normal modes {diameter, std, fractions[per SMOKE
aerosol species]}) into the per-cell emission contract read at init.  This
tool converts into the emission contract of ``make_inputs.write_emissions``:

* SMOKE-like input: a NetCDF with per-source gridded surface mass emission
  rates ``<source_name>`` [T, ny, nx] in kg m-2 s-1, and optionally gas
  fields ``gas_<NAME>`` [T, ny, nx] in mol m-2 s-1;
* ``emissions.json`` in the reference schema: each source's mass is spread
  across modes and SMOKE species; ``smoke_species`` names the columns of
  ``fractions`` and maps them onto aero_data species;
* mass -> number: each mode's mass share becomes a number rate through the
  log-normal mean particle volume v_mean = pi/6 d_g^3 exp(4.5 ln^2 sigma_g)
  and the mixture density of its species fractions.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..models.partmc.dist import AeroDist


def read_speciation(path: str):
    """Parse the reference-format emissions.json."""
    with open(path) as f:
        d = json.load(f)
    return d["sources"]


def _mode_mean_volume(d_g, sigma_g):
    """Mean single-particle volume of a log-normal mode [m3]."""
    return np.pi / 6.0 * d_g ** 3 * np.exp(4.5 * np.log(sigma_g) ** 2)


def convert_smoke(smoke_path: str, speciation_path: str, aero_data,
                  smoke_species, out_path: str, dz_surface: float,
                  gas_map=None, gas_n: int = 1,
                  species_alias=None):
    """SMOKE + speciation -> per-cell emission contract.

    smoke_species: names of the ``fractions`` columns in emissions.json;
    species_alias maps them to aero_data species names.  dz_surface [m]
    converts areal rates (kg m-2 s-1) to the volumetric rates of the
    contract (# m-3 s-1 within the surface layer).  Returns
    (times, AeroDist [T, ny, nx, M], gas_rate [T, ny, nx, G]) as CPU
    tensors.
    """
    from scipy.io import netcdf_file

    sources = read_speciation(speciation_path)
    alias = species_alias or {"poc": "OC", "pec": "BC", "pso4": "SO4",
                              "pno3": "NO3", "pnh4": "NH4", "pmfine": "OIN",
                              "pmc": "OIN", "na": "Na", "cl": "Cl"}
    S = aero_data.n_spec
    dens = aero_data.density.cpu().numpy()

    with netcdf_file(smoke_path, "r", mmap=False) as f:
        times = np.asarray(f.variables["time"][:], np.float64)
        T = len(times)
        fields = {k: np.asarray(v[:], np.float32)
                  for k, v in f.variables.items() if k != "time"}
    shape = next(iter(fields.values())).shape          # [T, ny, nx]
    ny, nx = shape[1:]

    modes = []          # per mode: (num_conc [T,ny,nx], d_g, sigma, vf[S],
                        #            source_id, weight_class)
    for src in sources:
        name = src["source_name"]
        if name not in fields:
            continue
        mass_rate = fields[name] / dz_surface          # kg m-3 s-1
        fr = np.array([m["fractions"] for m in src["modes"]], float)
        tot = fr.sum()
        if tot <= 0:
            continue
        for mi, mode in enumerate(src["modes"]):
            share = fr[mi].sum() / tot                 # mode's mass share
            if share <= 0:
                continue
            # map SMOKE species fractions onto aero species volumes
            vf = np.zeros(S)
            rho_eff_inv = 0.0
            for ci, sm in enumerate(smoke_species):
                sp = alias.get(sm.lower(), sm)
                if sp not in aero_data.names or fr[mi, ci] <= 0:
                    continue
                si = aero_data.names.index(sp)
                w = fr[mi, ci] / max(fr[mi].sum(), 1e-30)
                vf[si] += w / dens[si]
                rho_eff_inv += w / dens[si]
            if rho_eff_inv <= 0:
                continue
            vf = vf / vf.sum()
            d_g, sigma = float(mode["diameter"]), float(mode["std"])
            v_mean = _mode_mean_volume(d_g, sigma)
            # mass rate -> number rate through the mixture density
            num_rate = mass_rate * share * rho_eff_inv / v_mean
            modes.append((num_rate, d_g, sigma, vf,
                          int(src["source_class"]),
                          int(src["weight_class"])))

    if not modes:
        raise ValueError("no speciation source matched a SMOKE field")
    M = len(modes)
    num = np.stack([m[0] for m in modes], axis=-1)     # [T, ny, nx, M]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    dist = AeroDist(
        num_conc=f32(num),
        geom_mean_diam=f32([m[1] for m in modes]).expand(num.shape),
        log_geom_std=f32([np.log(m[2]) for m in modes]).expand(num.shape),
        vol_frac=f32(np.stack([m[3] for m in modes])).expand(num.shape + (S,)),
        source=i32([m[4] for m in modes]),
        w_class=i32([m[5] for m in modes]),
    )

    gas_rate = np.zeros((T, ny, nx, gas_n), np.float32)
    if gas_map:
        for field, (gi, scale) in gas_map.items():
            if field in fields:
                gas_rate[..., gi] = fields[field] * scale

    if out_path is not None:
        from .make_inputs import write_emissions

        write_emissions(out_path, times, dist, gas_rate)
    return f32(times), dist, torch.as_tensor(gas_rate)
