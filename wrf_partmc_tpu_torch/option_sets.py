"""The two physics option sets beyond the em_uniform and CARES paths.

Each is built by ``run.build_model`` (tests/test_torch_options_coupled.py
holds one step of each against the JAX package):

- mesoscale: the runner's em_uniform model (2 km, dt 10 s, live dynamics,
  the runner's particle physics, chemistry off) with the YSU surface layer
  and PBL, the slab LSM, Dudhia and gray radiation, WSM5 (5 moist species),
  BMJ and sea salt, on a sounding saturated over water (at most 15 g/kg).
  That sounding is no published case: it opens BMJ's and WSM5's gates in
  every column, so the path's physics split is their all-columns cost;
- les: tests/test_les.py's convective LES (dx 50 m, ztop 800 m, dt 0.25 s)
  with the prognostic TKE closure, the NBA stresses, WENO5/WENO3 and
  Kessler, from the test's warm bubble with near-surface noise, with the
  warm_bubble case's particles; no emission (its dist is empty) and the
  runner's 60 s coagulation cadence.

    model, state = build_option_set("mesoscale", 12, 12, 4, 16, 32, device="cpu")
    state = model(state)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import run
from .config import (BoundaryConfig, Config, DomainConfig, DynamicsConfig, PartmcConfig,
                     validate_config)
from .models.coupled.driver import decompose
from .models.dycore.ideal import init_warm_bubble_arw
from .models.dycore.state import replace, temperature, total_pressure
from .models.physics.thermo import saturation_mixing_ratio
from .utils import rng

RH_MESOSCALE, QV_MAX_MESOSCALE = 1.0, 0.015


def humid_sounding(dyn, grid, rh: float = RH_MESOSCALE, q_max: float = QV_MAX_MESOSCALE):
    """``dyn`` with qv = ``rh`` times the saturation mixing ratio over water
    at its temperature and pressure, at most ``q_max`` (the mass and
    geopotential are not rebalanced: the first acoustic substeps adjust to
    the water's weight)."""
    qsat = saturation_mixing_ratio(temperature(dyn, grid), total_pressure(dyn, grid))
    moist = dyn.moist.clone()
    moist[0] = torch.clamp(rh * qsat, max=q_max)
    return replace(dyn, moist=moist)


def les_initial_dyn(cfg, grid):
    """tests/test_les.py's dry warm bubble (1 K at 150 m, radius 120 m) with
    0.2 K normal noise in the two lowest levels (``rng.normal`` on key 0,
    the draw ``jax.random.normal`` makes there)."""
    s = init_warm_bubble_arw(cfg, grid, d_theta=1.0, z_center=150.0, z_radius=120.0)
    thp = s.theta_p.clone()
    thp[:2] = thp[:2] + rng.normal(rng.key(0), (2, grid.ny, grid.nx), thp.device) * 0.2
    return replace(s, theta_p=thp)


def lift_tails(state, frac: float = 1e-6):
    """``state`` with every particle's number lifted to at least ``frac`` of
    the largest: the em_uniform blob's tails fall to 1e-14 of its peak,
    where the monotonic limiter's outflow probabilities are round-off that
    differs between the card and the CPU (tests/test_torch_options_coupled.py
    starts from the same lift)."""
    num = state.aero.num
    lifted = torch.where(num > 0, torch.clamp(num, min=frac * float(num.max())), num)
    return dataclasses.replace(state, aero=dataclasses.replace(state.aero, num=lifted))


def _mesoscale_config(nx: int, ny: int, nz: int, particles: dict) -> Config:
    return Config(
        domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=2000.0, dy=2000.0),
        dynamics=DynamicsConfig(dt=10.0, chem_adv_opt="mono", moist_adv_opt="pd",
                                diff_opt=0, km_opt=4, bl_physics=1,
                                sf_surface_physics=1, ra_physics=1, mp_physics=2,
                                cu_physics=2),
        boundary=BoundaryConfig(periodic_x=True, periodic_y=True),
        partmc=PartmcConfig(seasalt_param=1, **particles), n_moist=5)


def _les_config(nx: int, ny: int, nz: int, particles: dict) -> Config:
    return Config(
        domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=50.0, dy=50.0, ztop=800.0),
        dynamics=DynamicsConfig(dt=0.25, n_sound=4, dyn_opt="arw", damp_opt=1, zdamp=200.0,
                                sfs_opt=1, diff_opt=2, km_opt=2, h_adv_order="weno5",
                                v_adv_order="weno3", mp_physics=1),
        boundary=BoundaryConfig(periodic_x=True, periodic_y=True),
        partmc=PartmcConfig(**dict(particles, do_emission=False)))


@dataclasses.dataclass(frozen=True)
class OptionSet:
    """What one option set is: its full-width and card-against-CPU shapes
    (nx, ny, nz), its ``Config`` maker (nx, ny, nz, the runner's particle
    keywords), the ``run.build_model`` case it starts from, its initial
    dycore state (cfg, grid, the case's dycore state) -> dycore state, and
    whether its particles' tails are lifted (``lift_tails``) before a
    decomposition or a card-against-CPU step."""
    full: tuple
    small: tuple
    config: Callable[[int, int, int, dict], Config]
    case: str
    initial_dyn: Callable
    lift_tails: bool


OPTION_SETS = {
    "mesoscale": OptionSet((40, 40, 10), (12, 12, 4), _mesoscale_config, "uniform",
                           lambda cfg, grid, dyn: humid_sounding(dyn, grid), True),
    "les": OptionSet((40, 40, 16), (12, 12, 8), _les_config, "warm_bubble",
                     lambda cfg, grid, dyn: les_initial_dyn(cfg, grid), False),
}


def _particles(n_part: int, cap: int) -> dict:
    """The runner's particle physics at ``n_part`` per cell in ``cap`` slots."""
    return dict(num_particles=n_part, max_particles=cap, n_emit_slots=4,
                partmc_chem_dt=60.0, do_coagulation=True, do_emission=True,
                do_deposition=True, do_transport=True, do_mosaic=False)


def option_config(name: str, nx: int, ny: int, nz: int, n_part: int, cap: int) -> Config:
    """The ``Config`` of option set ``name`` at nx x ny x nz cells."""
    return validate_config(OPTION_SETS[name].config(nx, ny, nz, _particles(n_part, cap)))


def build_option_set(name: str, nx: int, ny: int, nz: int, n_part: int, cap: int,
                     device="cuda", mesh=None):
    """Option set ``name`` through ``run.build_model`` (its case), its
    initial dycore state replaced by the set's: -> (CoupledModel,
    CoupledState).  With ``mesh``, this rank's part of it
    (``driver.decompose``), the tails lifted over the whole domain before
    the cut where the set lifts them; the whole-domain state is freed
    before the return."""
    spec = OPTION_SETS[name]
    cfg = validate_config(spec.config(nx, ny, nz, _particles(n_part, cap)))
    model, state = run.build_model(cfg, spec.case, device=device)
    state = dataclasses.replace(state, dyn=spec.initial_dyn(cfg, model.grid, state.dyn))
    if mesh is None:
        return model, state
    if spec.lift_tails:
        state = lift_tails(state)
    return decompose(model, state, mesh)
