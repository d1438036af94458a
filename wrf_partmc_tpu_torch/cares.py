"""The CARES-shaped coupled model: the port's twin of
``tools/cares_shape.py::build_cares_shape``.

A synthetic em_real-style domain in the image of the CARES configuration
(``namelist.input.cares``: dx = 4 km, 100 particles per cell, chem_dt 300 s,
CBM-Z + MOSAIC) with its full physics option set: MYJ surface layer and
PBL, correlated-k SW and LW radiation with the aerosol optics feedback,
Grell cumulus, Morrison microphysics with graupel, the Noah LSM, and open
lateral boundaries forced by a steady two-time wrfbdy (specified +
relaxation zones).  The same ``Config``, universe, scenario, initial state,
urban gas background, wrfbdy, zero ``exch_h`` and seeds as the reference,
so both packages start from the same state and draw the same streams.

    model, state = build_cares_shape(72, 72, 24)
    for _ in range(n):
        state = model(state)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (BoundaryConfig, Config, DomainConfig, DynamicsConfig,
                     PartmcConfig, validate_config)
from .entry import EMISSION_SOURCES, require_device
from .grid import make_grid
from .models.coupled.bdy import make_bdy
from .models.coupled.driver import CoupledModel, init_coupled
from .models.coupled.init import populate_from_dist
from .models.dycore.ideal import init_uniform
from .models.dycore.state import temperature, total_pressure
from .models.partmc.aero_data import make_aero_data
from .models.partmc.dist import concat_dists, make_mode
from .models.partmc.gas_data import make_gas_data, make_gas_data_cbmz
from .models.partmc.scenario import constant_scenario
from .models.partmc.sources import build_universe, validate_universe
from .models.physics.thermo import saturation_mixing_ratio
from .utils import rng
from .utils.at import set_at

# urban trace-gas background [ppb] of the CARES shape
GAS_BACKGROUND = dict(O3=40.0, NO2=8.0, NO=2.0, SO2=4.0, NH3=3.0, HNO3=1.0,
                      HCHO=2.0, CO=150.0, CH4=1800.0)


def cares_config(nx, ny, nz, n_part=100, cap=128, dt=30.0, chem_on=True) -> Config:
    """The CARES option set (n_class is set by the caller from the
    universe)."""
    return Config(
        domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=4000.0, dy=4000.0, ztop=16000.0),
        dynamics=DynamicsConfig(
            dt=dt, n_sound=4, dyn_opt="arw", damp_opt=1, zdamp=4000.0,
            mp_physics=10, ra_physics=4, bl_physics=2, cu_physics=5,
            sf_surface_physics=2, diff_opt=2, km_opt=4),
        boundary=BoundaryConfig(periodic_x=False, periodic_y=False,
                                open_xs=True, open_xe=True, open_ys=True, open_ye=True,
                                spec_zone=1, relax_zone=4),
        partmc=PartmcConfig(num_particles=n_part, max_particles=cap,
                            n_emit_slots=4, partmc_chem_dt=300.0,
                            do_coagulation=True, do_emission=True,
                            do_deposition=True, do_mosaic=chem_on,
                            do_transport=True, do_condensation=chem_on,
                            do_optical=chem_on),
        n_moist=10, n_moist_mass=6,
        n_chem_gas=77 if chem_on else 32)


def build_cares_shape(nx, ny, nz, n_part=100, cap=128, dt=30.0, chem_on=True,
                      n_class_sources=6, device="cuda", mesh=None):
    """Build the CARES-shaped coupled model and its initial state on
    ``device`` (the card unless the caller names another; raises on a host
    without CUDA).  With ``mesh`` (``parallel.mesh.Mesh``), the model and
    the state are this rank's blocks of the global build.  Returns
    ``(CoupledModel, CoupledState)``."""
    require_device(device)
    cfg = cares_config(nx, ny, nz, n_part, cap, dt, chem_on)
    ad = make_aero_data(device=device)
    gd = make_gas_data_cbmz(device=device) if chem_on else make_gas_data(device=device)
    vf = np.zeros(ad.n_spec)
    vf[0] = 1.0
    em_named = [(name, make_mode(nc, gmd, gsd, vf, device=device))
                for name, nc, gmd, gsd in EMISSION_SOURCES[:n_class_sources]]
    uni, (ic,), _, em_d = build_universe(
        ic=[("background", make_mode(3e8, 1e-7, 1.8, vf, device=device))],
        emissions=em_named)
    cfg = cfg.replace(n_class=max(8, uni.n_class))
    validate_universe(uni, cfg.n_class)
    validate_config(cfg)
    grid = make_grid(cfg, device=device)

    # synthetic base flow: uniform westerly, half-saturated moisture
    dyn = init_uniform(cfg, grid, 8.0, 1.0)
    qsat = saturation_mixing_ratio(temperature(dyn, grid), total_pressure(dyn, grid))
    dyn = dataclasses.replace(dyn, moist=set_at(dyn.moist, 0,
                                                0.5 * torch.clamp(qsat, max=0.01), dim=0))
    cs = init_coupled(cfg, grid, ad, gd, dyn, mesh=mesh)
    aero = populate_from_dist(ad, cfg, grid, ic, rng.key(0),
                              block=mesh.draw_block(ny, nx) if mesh is not None else None)
    gas = cs.gas
    if chem_on:
        for name, ppb in GAS_BACKGROUND.items():
            gas = set_at(gas, gd.spec_by_name(name), ppb)
    cs = dataclasses.replace(cs, aero=aero, gas=gas)
    scn = constant_scenario(ad, gd.n_spec, concat_dists(em_d))

    # steady wrfbdy from the initial state, six hours apart
    bdy = make_bdy([0.0, 6 * 3600.0], [dyn, dyn],
                   width=cfg.boundary.spec_zone + cfg.boundary.relax_zone, chem=True)
    exch = torch.zeros((grid.nz + 1, grid.ny, grid.nx), dtype=torch.float32,
                       device=device)
    return CoupledModel(cfg, grid, ad, gd, scn, exch, seed=0, bdy=bdy, mesh=mesh), cs
