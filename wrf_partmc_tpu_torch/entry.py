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
draw).  ``dryrun_multichip(n)`` runs one decomposed step over n ranks.
"""

from __future__ import annotations

import dataclasses
import sys

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


# the JAX package's bound on one collective's float32 payload
MAX_COLLECTIVE_FLOATS = 4_000_000


def dryrun_multichip(n: int, device="cuda", timeout_s: float = 600.0) -> dict:
    """One decomposed coupled step over ``n`` ranks at a local block of 4x4
    cells (the twin of ``__graft_entry__.dryrun_multichip``): the
    ``factor_2d(n)`` mesh, 4 levels, 8 particles per cell.  In a world of
    ``n`` ranks it steps this rank's block; with no process group it
    starts the ``n`` ranks itself (``parallel.launch``) and raises if one
    fails.  Asserts that edge buffers moved between ranks whenever a mesh
    axis is wider than 1, that no collective carried more than
    ``MAX_COLLECTIVE_FLOATS`` floats, and that the step stayed finite.
    Returns this rank's summary (with no process group: rank 0's output)."""
    import torch.distributed as dist

    from .parallel import distributed as pdist, halo
    from .parallel.launch import spawn
    from .parallel.mesh import factor_2d

    if not dist.is_initialized():
        code = ("from wrf_partmc_tpu_torch.parallel import distributed as d; "
                "from wrf_partmc_tpu_torch.entry import dryrun_multichip as f; "
                f"d.init_from_env({str(device)!r}, {timeout_s}); f({n}, {str(device)!r}); "
                "d.shutdown()")
        results = spawn(n, [sys.executable, "-c", code], timeout_s)
        bad = [(r, c, out[-2000:]) for r, (c, out) in enumerate(results) if c != 0]
        if bad:
            raise RuntimeError(f"dryrun_multichip: ranks failed: {bad}")
        return {"output": results[0][1]}
    if dist.get_world_size() != n:
        raise ValueError(f"dryrun_multichip({n}) in a world of {dist.get_world_size()}")
    py, px = factor_2d(n)
    mesh = pdist.global_mesh((py, px))
    if mesh.device.type != torch.device(device).type:
        raise ValueError(f"dryrun_multichip on {device!r} in a {mesh.device.type} world")
    model, state = build(nx=4 * px, ny=4 * py, nz=4, n_part=8, cap=24,
                         device=mesh.device, mesh=mesh)
    halo.reset_counts()
    out = model(state)
    counts = halo.read_counts()
    if py > 1 or px > 1:
        assert counts["p2p"]["calls"] > 0, "no edge buffer moved between ranks"
    big = max(rec["max_bytes"] for rec in counts.values()) // 4
    assert big <= MAX_COLLECTIVE_FLOATS, f"a collective carried {big} floats"
    assert bool(torch.isfinite(out.dyn.theta_p).all()) and bool(torch.isfinite(
        out.aero.num).all()), "the step is not finite"
    alive = int(halo.all_reduce_sum(out.aero.n_alive().sum().to(torch.float32), mesh))
    summary = dict(mesh=(py, px), rank=mesh.rank, alive=alive, collectives=counts)
    print(f"dryrun_multichip OK: mesh {py}x{px}, rank {mesh.rank}, step executed, "
          f"{counts['p2p']['calls']} edge exchanges, largest collective {big} floats, "
          f"total particles alive = {alive}", flush=True)
    return summary
