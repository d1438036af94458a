"""em_uniform as WRF-PartMC's ``test/em_uniform`` runs it, on the pieces of
``entry.build(everything_on=False)``: stochastic transport of the
particles through the live ARW dycore, no other process.  The seed's key
draws the initial population and feeds the model's random streams."""

import dataclasses

import numpy as np
import torch

from benchmark.builders import PROGRAM, check_config, module, seed_words

COUPLED = ("do_coagulation", "do_emission", "do_deposition")   # entry's everything_on


def build(config: dict, traffic: dict, seed: int, device, root: str = PROGRAM):
    entry = module(root, "entry")
    make_grid = module(root, "grid").make_grid
    driver = module(root, "models.coupled.driver")
    populate_from_dist = module(root, "models.coupled.init").populate_from_dist
    init_uniform = module(root, "models.dycore.ideal").init_uniform
    make_aero_data = module(root, "models.partmc.aero_data").make_aero_data
    dist = module(root, "models.partmc.dist")
    make_gas_data = module(root, "models.partmc.gas_data").make_gas_data
    constant_scenario = module(root, "models.partmc.scenario").constant_scenario
    sources = module(root, "models.partmc.sources")
    k_profile_exch_h = module(root, "models.physics.pbl").k_profile_exch_h
    rng = module(root, "utils.rng")

    entry.require_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    procs = config["processes"]
    if len({procs[k] for k in COUPLED}) != 1 or procs["do_mosaic"] or not procs["do_transport"]:
        raise ValueError(f"em_uniform's build switches {COUPLED} together, with transport "
                         f"on and no chemistry: {procs}")
    cfg = entry.make_config(config["nx"], config["ny"], config["nz"],
                            traffic["particles_per_cell"], traffic["slots_per_cell"],
                            everything_on=procs["do_emission"],
                            chem_dt=config["partmc_chem_dt"], chem_on=False)
    check_config(cfg, config)
    ad = make_aero_data(device=device)
    gd = make_gas_data(device=device)
    vf = np.zeros(ad.n_spec)
    vf[0] = 1.0
    em_named = [(name, dist.make_mode(nc, gmd, gsd, vf, device=device))
                for name, nc, gmd, gsd in entry.emission_sources()]
    uni, (ic,), _, em_d = sources.build_universe(
        ic=[("background", dist.make_mode(1e9, 1e-7, 1.6, vf, device=device))],
        emissions=em_named)
    cfg = cfg.replace(n_class=max(8, uni.n_class))
    sources.validate_universe(uni, cfg.n_class)
    grid = make_grid(cfg, device=device)
    scn = constant_scenario(ad, gd.n_spec, dist.concat_dists(em_d))
    dyn = init_uniform(cfg, grid, 5.0, 2.0)
    cs = driver.init_coupled(cfg, grid, ad, gd, dyn)
    key = rng.Key(seed_words(seed))
    cs = dataclasses.replace(cs, aero=populate_from_dist(ad, cfg, grid, ic, key))
    exch = k_profile_exch_h(grid, 0.4, 800.0)
    model = driver.CoupledModel(cfg, grid, ad, gd, scn, exch, seed=0)
    model.base_key = key
    return model, cs
