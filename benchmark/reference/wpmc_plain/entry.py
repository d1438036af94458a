"""Entry point of the port: the em_uniform coupled model.

``build`` is the twin of ``__graft_entry__._build`` of the JAX package: the
same configuration, source universe, scenario, initial state and seeds, so
both packages start from the same state and draw the same random streams.
With ``chem_on`` the chemistry macro-step runs the 77-species CBM-Z +
MOSAIC step over an urban trace-gas background.

    model, state = build(40, 40, 10, n_part=1000, cap=1280)
    for _ in range(n):
        state = model(state)

The model is built on the card unless the caller names another device
(``device="cpu"``, as the CPU tests do); on a host without CUDA the
default raises instead of running on the CPU.

With ``mesh`` (``parallel.mesh.Mesh``) the build is one rank's of the
decomposed model: the global build cut to this rank's block of every
field (the block grid, the dycore, land and PBL states, the particles and
gases, the particles drawn as the block's slice of the global initial
draw).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import DomainConfig, PartmcConfig, uniform_test_config
from .grid import make_grid
from .models.coupled.driver import CoupledModel, init_coupled
from .models.coupled.init import populate_from_dist
from .models.dycore.ideal import init_uniform
from .models.partmc.aero_data import make_aero_data
from .models.partmc.dist import concat_dists, make_mode
from .models.partmc.gas_data import make_gas_data, make_gas_data_cbmz
from .models.partmc.scenario import constant_scenario
from .models.partmc.sources import build_universe, validate_universe
from .models.physics.pbl import k_profile_exch_h
from .utils import rng
from .utils.at import set_at

# (name, number conc [# m-3 s-1], geometric mean diameter [m], sigma_g):
# one IC background plus six emission sources, each its own weight class
EMISSION_SOURCES = (("traffic", 4e4, 5e-8, 1.8), ("industry", 2e4, 1e-7, 2.0),
                    ("biomass", 1e4, 8e-8, 1.7), ("dust", 5e3, 5e-7, 1.9),
                    ("cooking", 2e4, 6e-8, 1.6), ("shipping", 1e4, 9e-8, 1.8))

# urban-plume-like trace-gas background [ppb] so CBM-Z has work
GAS_BACKGROUND = dict(O3=40.0, NO2=10.0, NO=2.0, SO2=5.0, NH3=3.0, HNO3=1.0,
                      HCHO=2.0, CO=150.0, CH4=1800.0)


def emission_sources(n_sources=None):
    """The emission sources of ``_build``: the six above, or ``n_sources``
    programmatic SMOKE-sector-like ones cycled from them (at 38 the universe
    reaches the reference's CARES ~40 weight classes)."""
    if n_sources is None:
        return list(EMISSION_SOURCES)
    base = EMISSION_SOURCES
    return [(f"{base[i % len(base)][0]}_{i:02d}",
             base[i % len(base)][1] * (0.5 + 0.1 * (i % 7)),
             base[i % len(base)][2] * (0.8 + 0.05 * (i % 5)),
             base[i % len(base)][3])
            for i in range(n_sources)]


def make_config(nx, ny, nz, n_part, cap, everything_on=True, chem_dt=60.0,
                chem_on=False, dyn_opt="arw"):
    """The em_uniform configuration of ``__graft_entry__._build`` with live
    dynamics; ``chem_on`` turns MOSAIC on over the 77-gas registry;
    ``dyn_opt="linear"`` runs the linear core."""
    cfg = uniform_test_config().replace(
        domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=2000.0, dy=2000.0, ztop=2000.0),
        partmc=PartmcConfig(num_particles=n_part, max_particles=cap,
                            n_emit_slots=4, partmc_chem_dt=chem_dt,
                            do_coagulation=everything_on,
                            do_emission=everything_on,
                            do_deposition=everything_on,
                            do_mosaic=chem_on, do_transport=True))
    cfg = cfg.replace(dynamics=dataclasses.replace(cfg.dynamics, dyn_opt=dyn_opt,
                                                   constant_velocity=False))
    if chem_on:
        cfg = cfg.replace(n_chem_gas=77)
    return cfg


def require_device(device) -> None:
    """Raise when ``device`` is a CUDA device and this host has none."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA device is "
                           "available; pass device=\"cpu\" to run on the CPU")


def build(nx=12, ny=12, nz=4, n_part=16, cap=48, everything_on=True,
          chem_on=False, chem_dt=60.0, n_sources=None, dyn_opt="arw", device="cuda",
          mesh=None):
    """Build the coupled model and its initial state on ``device``; with
    ``mesh``, this rank's part of the decomposed model.  Returns
    ``(CoupledModel, CoupledState)``."""
    require_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 einsums/matmuls
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_config(nx, ny, nz, n_part, cap, everything_on, chem_dt, chem_on, dyn_opt)
    ad = make_aero_data(device=device)
    gd = make_gas_data_cbmz(device=device) if chem_on else make_gas_data(device=device)
    vf = np.zeros(ad.n_spec)
    vf[0] = 1.0
    em_named = [(name, make_mode(nc, gmd, gsd, vf, device=device))
                for name, nc, gmd, gsd in emission_sources(n_sources)]
    uni, (ic,), _, em_d = build_universe(
        ic=[("background", make_mode(1e9, 1e-7, 1.6, vf, device=device))],
        emissions=em_named)
    cfg = cfg.replace(n_class=max(8, uni.n_class))
    validate_universe(uni, cfg.n_class)
    grid = make_grid(cfg, device=device)
    scn = constant_scenario(ad, gd.n_spec, concat_dists(em_d))
    dyn = init_uniform(cfg, grid, 5.0, 2.0)
    cs = init_coupled(cfg, grid, ad, gd, dyn, mesh=mesh)
    aero = populate_from_dist(ad, cfg, grid, ic, rng.key(0),
                              block=mesh.draw_block(ny, nx) if mesh is not None else None)
    gas = cs.gas
    if chem_on:
        for name, ppb in GAS_BACKGROUND.items():
            gas = set_at(gas, gd.spec_by_name(name), ppb)
    cs = dataclasses.replace(cs, aero=aero, gas=gas)
    exch = k_profile_exch_h(grid, 0.4, 800.0)
    model = CoupledModel(cfg, grid, ad, gd, scn, exch, seed=0, mesh=mesh)
    return model, cs


