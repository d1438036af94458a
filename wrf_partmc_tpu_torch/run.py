"""The model runner, the port's ``wrf.exe``: twin of ``wrf_partmc_tpu/run.py``.

The host loop steps the coupled model and handles the clock's alarms: the
WRF-style history and the particle-state file (``history``), the gridded
aerosol diagnostics with the mixing-state metrics (``auxhist2``), and the
restart (``restart``), with section timers and the memory tracker.  Output
files are written by the native quilt pool while the card steps on.

    python -m wrf_partmc_tpu_torch.run --namelist namelist.input --case uniform \\
        --outdir out/ [--steps N] [--restart R] [--seed S] [--device cuda|cpu]

The model is built on ``cuda`` unless ``--device cpu`` is given; without
a card the default raises.  The file-driven initializations of the
reference (``--ics``, ``--emissions``, ``--bcs``, ``--spec``,
``--wrfinput``) are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from .config import Config, namelist_to_config, uniform_test_config, validate_config
from .entry import require_device
from .grid import make_grid
from .models.coupled.driver import (TRANSPORT_COUNTERS, CoupledModel, init_coupled,
                                    make_env)
from .models.coupled.init import populate_from_dist, populate_from_number_field
from .models.dycore.ideal import init_rotational, init_scm, init_uniform, init_warm_bubble
from .models.partmc.aero_data import make_aero_data
from .models.partmc.bin_grid import make_bin_grid
from .models.partmc.diagnostics import process
from .models.partmc.dist import make_mode
from .models.partmc.gas_data import make_gas_data
from .models.partmc.scenario import constant_scenario
from .models.physics.pbl import k_profile_exch_h
from .utils import rng
from .utils.clock import Clock
from .utils.io import (read_restart, read_restart_netcdf, write_aero_removed, write_history,
                       write_particle_netcdf, write_restart, write_restart_netcdf)
from .utils.namelist import load_namelist
from .utils.quilt import QuiltWriter
from .utils.timing import SectionTimers, memtrack_mb

CASES = {
    "uniform": init_uniform,
    "rotational": init_rotational,
    "warm_bubble": init_warm_bubble,
    "scm": init_scm,
}

FILE_FLAGS = ("ics", "emissions", "bcs", "spec", "wrfinput")


def build_model(cfg: Config, case: str = "uniform", seed: int = 0,
                input_files: dict | None = None, device="cuda"):
    """The coupled model and its initial state for an ideal ``case`` on
    ``device``: -> ``(CoupledModel, CoupledState)``.  uniform and
    rotational start their particles from the case's number field (one
    monodisperse SO4 population matching the NUM_CONC tracer); warm_bubble
    and scm sample a 1e9 m-3 log-normal mode into every cell.  Emission
    draws from an empty dist, so it dilutes only.  ``input_files``, the
    reference's file-driven initializations, are not ported and raise."""
    given = sorted(k for k, v in (input_files or {}).items() if v)
    if given:
        raise NotImplementedError(
            f"file-driven initialization ({', '.join('--' + k for k in given)}) is not "
            "ported: it needs models/coupled/init.py::init_from_files (ics, emissions, "
            "bcs), init.py::init_from_spec (spec) and models/dycore/real.py (wrfinput)")
    require_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 einsums/matmuls
    torch.backends.cudnn.allow_tf32 = False
    ad = make_aero_data(device=device)
    gd = make_gas_data(device=device)
    vf = np.zeros(ad.n_spec)
    vf[ad.spec_by_name("SO4")] = 1.0
    grid = make_grid(cfg, device=device)
    dyn = CASES[case](cfg, grid)
    cs = init_coupled(cfg, grid, ad, gd, dyn)
    scn = constant_scenario(ad, gd.n_spec, make_mode(0.0, 1e-7, 1.6, vf, device=device))
    if case in ("uniform", "rotational"):
        aero = populate_from_number_field(ad, cfg, grid, dyn.num_conc[0], rng.base_key(seed))
    else:
        ic = make_mode(1e9, 1e-7, 1.6, vf, device=device)
        aero = populate_from_dist(ad, cfg, grid, ic, rng.base_key(seed))
    cs = dataclasses.replace(cs, aero=aero)
    exch = k_profile_exch_h(grid, 0.4, 800.0)
    model = CoupledModel(cfg, grid, ad, gd, scn, exch, seed=cfg.partmc.random_seed or seed)
    return model, cs


def _removal_rows(step: int, diag: dict):
    """The coagulation events of a step as (step, flat cell, removed id,
    partner id) rows, selected on the device; one copy to the host."""
    rid = diag["coag_removed_id"].reshape(-1, diag["coag_removed_id"].shape[-1])
    oid = diag["coag_other_id"].reshape(rid.shape)
    cell, pair = torch.nonzero(rid >= 0, as_tuple=True)
    rows = torch.stack([torch.full_like(cell, step), cell, rid[cell, pair].long(),
                        oid[cell, pair].long()], dim=1)
    return rows.cpu().numpy()


def run(cfg: Config, case: str, outdir: str, seed: int = 0,
        restart_path: str | None = None, verbose: bool = True,
        input_files: dict | None = None, restart_format: str = "npz",
        device="cuda"):
    """Run ``case`` for ``cfg.time_control.run_seconds`` with the history,
    auxhist2 and restart alarms; -> (final CoupledState, SectionTimers).
    ``restart_path`` resumes from an npz or (``.nc``) NetCDF restart;
    ``restart_format`` is "npz" (exact, same shape) or "netcdf" (portable
    across capacities and packages).  ``restart_final.npz`` is always
    written at the end."""
    if restart_format not in ("npz", "netcdf"):
        raise ValueError(f"restart_format {restart_format!r} is not npz or netcdf")
    os.makedirs(outdir, exist_ok=True)
    model, cs = build_model(cfg, case, seed, input_files, device)
    grid, ad = model.grid, model.aero_data
    if restart_path:
        if restart_path.endswith(".nc"):
            cs = read_restart_netcdf(restart_path, cs, ad)
        else:
            cs = read_restart(restart_path, cs)
    pc, tc = cfg.partmc, cfg.time_control
    bg = make_bin_grid(pc.num_bins, pc.bin_d_min, pc.bin_d_max, device=device)

    clock = Clock(dt=cfg.dynamics.dt, t_stop=tc.run_seconds, step=cs.step)
    clock.add_alarm("history", tc.history_interval_s)
    clock.add_alarm("auxhist2", tc.auxhist2_interval_s)
    clock.add_alarm("restart", tc.restart_interval_s)
    on_card = torch.device(device).type == "cuda"
    timers = SectionTimers(sync=torch.cuda.synchronize if on_card else None)
    quilt = QuiltWriter()
    path = lambda stem: os.path.join(outdir, stem)

    # transport saturation counters, summed on the host across steps; the
    # coagulation removal records, kept as rows until the next history alarm
    tdiag_acc = {k: 0.0 for k in TRANSPORT_COUNTERS}
    warned_overflow = False
    aero_info_rows = []
    m_chem = max(1, int(round(pc.partmc_chem_dt / cfg.dynamics.dt)))

    while not clock.done():
        diag = None
        if clock.ringing("auxhist2"):
            with timers.section("partmc_process"):
                env = make_env(cs.dyn, grid, cfg, cs.step)
                diag = process(cs.aero, ad, env, bg, advanced=pc.do_advanced_process)
        if clock.ringing("history"):
            with timers.section("history_write"):
                write_history(path(f"wrfout_{clock.step:06d}.nc"), cs, grid, cfg, diag,
                              writer=quilt,
                              trans_diag=tdiag_acc if pc.do_transport else None)
                write_particle_netcdf(path(f"partmc_{clock.step:06d}.nc"), cs, ad, grid,
                                      with_optics=pc.do_optical, writer=quilt)
                if aero_info_rows:
                    write_aero_removed(path(f"aero_removed_{clock.step:06d}.nc"),
                                       aero_info_rows, writer=quilt)
                    aero_info_rows = []
        if clock.step > 0 and clock.ringing("restart"):
            with timers.section("restart_write"):
                if restart_format == "netcdf":
                    write_restart_netcdf(path(f"restart_{clock.step:06d}.nc"), cs, ad, grid,
                                         writer=quilt)
                else:
                    write_restart(path(f"restart_{clock.step:06d}.npz"), cs, writer=quilt)
        with timers.section("coupled_step"):
            was_chem_step = clock.step % m_chem == 0
            cs = model(cs)
            step_diag = model.last_diag
            # the three counters in one copy (the step's one host sync)
            counts = torch.stack([step_diag[k] for k in TRANSPORT_COUNTERS]).tolist()
            for k, v in zip(TRANSPORT_COUNTERS, counts):
                tdiag_acc[k] += v
            if (not warned_overflow and tdiag_acc["movers"] > 0
                    and tdiag_acc["overflow_class"] > 0.02 * tdiag_acc["movers"]):
                print("WARNING: transport mover-cap overflow exceeds 2% of "
                      f"movers ({tdiag_acc['overflow_class']:.0f} of "
                      f"{tdiag_acc['movers']:.0f}); consider raising "
                      "partmc.trans_cap_v (e.g. 2*num_particles/nz) for this regime")
                warned_overflow = True
            if "coag_removed_id" in step_diag and was_chem_step:
                rows = _removal_rows(clock.step, step_diag)
                if rows.size:
                    aero_info_rows.append(rows)
        clock.advance()
        if verbose and clock.step % 50 == 0:
            print(f"step {clock.step}  t={clock.t:.0f}s  maxrss={memtrack_mb():.0f} MB")

    if aero_info_rows:       # records gathered since the last alarm
        write_aero_removed(path(f"aero_removed_{clock.step:06d}.nc"), aero_info_rows,
                           writer=quilt)
    with timers.section("restart_write"):
        write_restart(path("restart_final.npz"), cs)
    quilt.flush()
    if verbose:
        print("Timing summary:")
        print(timers.report())
    return cs, timers


def main(argv=None, configure=None):
    """The command line; ``configure``, when given, maps the ``Config``
    after the namelist and ``--steps`` (for options the namelist shim does
    not map).  Returns (final state, timers)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--namelist", help="WRF-style namelist.input")
    ap.add_argument("--case", default="uniform", choices=sorted(CASES))
    ap.add_argument("--outdir", default="wrfout")
    ap.add_argument("--steps", type=int, help="override run length in steps")
    ap.add_argument("--restart", help="restart (.npz, or .nc NetCDF) to resume from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    for flag in FILE_FLAGS:
        ap.add_argument(f"--{flag}", help="not ported (raises NotImplementedError)")
    args = ap.parse_args(argv)

    cfg = (namelist_to_config(load_namelist(args.namelist)) if args.namelist
           else uniform_test_config())
    if args.steps:
        cfg = cfg.replace(time_control=dataclasses.replace(
            cfg.time_control, run_seconds=args.steps * cfg.dynamics.dt))
    if configure is not None:
        cfg = configure(cfg)
    validate_config(cfg)
    files = {k: getattr(args, k) for k in FILE_FLAGS}
    cs, timers = run(cfg, args.case, args.outdir, args.seed, args.restart,
                     input_files=files, device=args.device)
    print(json.dumps({"steps": cs.step,
                      "total_particles": float(cs.aero.total_num().sum())}))
    return cs, timers


if __name__ == "__main__":
    main()
