"""Benchmark of the port: prints ONE JSON line.

    python -m wrf_partmc_tpu_torch.bench [--preset tiny|full]

The twin of the repository's ``bench.py``, the JAX package's measuring
entry point, with its workers, sweeps, sizes and keys.  Headline:
solve_em-equivalent grid-points/s on a live-dynamics dycore step (the ARW
core at 128x128x40, a warm bubble); under ``extra`` the coupled em_uniform
reference problem (40x40x10 at 2 km) walking the particle-count sweep
{1000, 500, 200, 100} per cell, the same problem with chemistry on (CBM-Z +
MOSAIC, chem_dt 300 s) and with the 40-class universe (``n_sources=38``),
and the CARES shape (``cares.build_cares_shape``) at the largest grid of
its list that runs.

Each measurement runs in its own process (``_spawn``), so a point that
fails (out of memory) cannot leave a fragmented allocator to the next one.
A worker builds its model through the port's entry points only (the
builders below mirror ``bench.py``'s with the same arguments), runs one
warm-up window of n steps and then three timed windows of n steps, each
ended by ``torch.cuda.synchronize()``, carrying the state from window to
window, and reports the median window (``_time_run``); the CARES worker
keeps ``bench.py``'s own scheme: one warm-up step, then n steps in one
window.  The worker keeps one state alive at a time: the step's input
is dropped as its output takes its place.

Deliberate differences from ``bench.py``:

- no ``vs_baseline``: ``bench.py`` divides by the value of the newest
  ``BENCH_r*.json``, which holds TPU numbers; this bench reads none, and
  every number it prints is this device's own;
- ``extra.device`` is the card's name and power limit
  (``torch.cuda.get_device_name(0)`` and ``nvidia-smi``), or ``cpu``;
- two additions for each worker, named by the prefix of its keys
  (``dycore``, ``coupled_em_uniform``, ``coupled_chem_on``,
  ``coupled_40class``, ``cares_shape``): ``<prefix>_peak_gib``, the peak
  memory of the build and of the steps (``torch.cuda.max_memory_allocated``,
  the stats reset after the build; on the CPU the process's peak resident
  set, which cannot be reset, so its steps figure includes the build),
  and ``<prefix>_window_ms``, each timed window's ms/step.

Both presets run every worker on ``--device`` (default ``cuda``); a
worker that finds no card raises (``entry.require_device``).  ``--preset
tiny`` is the smoke preset (dycore 32x32x8, coupled 12x12x4 at 32 per
cell, 5 steps, no CARES); on a host without a card it runs with
``--device cpu``.  Every worker also prints, on an earlier line of the
main process, its own result with the kernels' launches over its windows.

A sweep moves to its next point only when the worker's stderr says that it
ran out of device memory (``torch.OutOfMemoryError``, "CUDA out of
memory"); any other failure of a worker (an exception, no result line, its
time limit) ends the run with exit code 1 and that worker's stderr tail.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2.0 ** 30


def _build_dycore(nx, ny, nz, device="cuda"):
    """The ARW dycore alone on a warm bubble at 2 km, dt 10 s, four
    acoustic substeps (``bench.py::_build_dycore``).  Returns ``(step,
    state)``: ``step(s)`` is one ``solve_step``."""
    from .config import Config, DomainConfig, DynamicsConfig
    from .entry import require_device
    from .grid import make_grid
    from .models.dycore.ideal import init_warm_bubble
    from .models.dycore.solve import solve_step

    require_device(device)
    cfg = Config(domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=2000.0, dy=2000.0),
                 dynamics=DynamicsConfig(dt=10.0, n_sound=4))
    grid = make_grid(cfg, device=device)
    state = init_warm_bubble(cfg, grid)

    def step(s):
        return solve_step(s, grid, cfg)[0]

    return step, state


def _build_coupled(nx, ny, nz, n_part, cap, chem_on=False, n_sources=None,
                   device="cuda"):
    """The em_uniform coupled step with everything on
    (``bench.py::_build_coupled``): ``entry.build`` with chem_dt 300 s when
    chemistry is on, else 60 s.  Returns ``(CoupledModel, CoupledState)``."""
    from .entry import build

    return build(nx=nx, ny=ny, nz=nz, n_part=n_part, cap=cap, everything_on=True,
                 chem_on=chem_on, chem_dt=300.0 if chem_on else 60.0,
                 n_sources=n_sources, device=device)


def _build_cares(nx, ny, nz, n_part, cap, device="cuda"):
    """The CARES shape (``bench.py::worker_cares``): ``build_cares_shape``
    with its defaults (dt 30 s, chemistry on, six emission classes)."""
    from .cares import build_cares_shape

    return build_cares_shape(nx, ny, nz, n_part=n_part, cap=cap, device=device)


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _is_cuda(device):
        torch.cuda.synchronize(device)


def _peak_gib(device) -> float:
    """Peak device memory since the last reset, or on the CPU the process's
    peak resident set (``ru_maxrss``, KiB on Linux)."""
    if _is_cuda(device):
        return torch.cuda.max_memory_allocated(device) / GIB
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / GIB


def _kernels() -> dict:
    from .ops import mie_fit, place, threefry, tridiag

    return {"thomas_solve": tridiag.thomas_solve, "scatter_rows": place.scatter_rows_cuda,
            "gather_rows": place.gather_rows_cuda, "threefry_draw": threefry.threefry_draw,
            "mie_fit_bulk": mie_fit.mie_fit_bulk}


class _Meter:
    """The build's peak, then, from ``start()`` on, the steps' peak and the
    kernels' launches."""

    def __init__(self, device):
        self.device = device
        _sync(device)
        self.build_gib = _peak_gib(device)

    def start(self) -> None:
        if _is_cuda(self.device):
            torch.cuda.reset_peak_memory_stats(self.device)
        for fn in _kernels().values():
            fn.launches = 0

    def report(self) -> dict:
        _sync(self.device)
        return {"peak_gib": {"build": self.build_gib, "steps": _peak_gib(self.device)},
                "launches": {k: fn.launches for k, fn in _kernels().items()}}


def _time_run(build, n_steps, device, n_rep=3):
    """``build()`` -> ``(step, state)``; one warm-up window of ``n_steps``
    steps, then ``n_rep`` timed windows, the state carried through all.
    Returns (median window s, each window's s, final state, meter report)."""
    step, state = build()
    meter = _Meter(device)
    meter.start()
    times = []
    for w in range(n_rep + 1):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = step(state)
        _sync(device)
        if w:
            times.append(time.perf_counter() - t0)
    return statistics.median(times), times, state, meter.report()


def _device_name(device) -> str:
    """The card's name and power limit, or ``cpu``."""
    if not _is_cuda(device):
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    limit = lines[torch.device(device).index or 0].split(",")[-1].strip()
    return f"{torch.cuda.get_device_name(device)}, {limit}"


def _require_finite(t: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError(f"{what} is not finite")


# ---------------------------------------------------------------- workers

def _window_ms(times, n) -> list:
    return [1e3 * t / n for t in times]


def worker_dycore(args) -> dict:
    n = args.steps
    t, times, out, rep = _time_run(
        lambda: _build_dycore(args.nx, args.ny, args.nz, args.device), n, args.device)
    _require_finite(out.theta_p, "theta_p")
    return {"t": t, "window_ms": _window_ms(times, n), "device": _device_name(args.device),
            **rep}


def worker_coupled(args) -> dict:
    n = args.steps
    t, times, out, rep = _time_run(
        lambda: _build_coupled(args.nx, args.ny, args.nz, args.n_part, args.cap,
                               chem_on=bool(args.chem), n_sources=args.n_sources or None,
                               device=args.device), n, args.device)
    _require_finite(out.dyn.theta_p, "theta_p")
    return {"t": t, "window_ms": _window_ms(times, n),
            "alive": float(out.aero.n_alive().sum()), "cap": int(out.aero.num.shape[-1]),
            **rep}


def worker_cares(args) -> dict:
    model, state = _build_cares(args.nx, args.ny, args.nz, args.n_part, args.cap,
                                args.device)
    meter = _Meter(args.device)
    meter.start()
    state = model(state)
    _sync(args.device)
    n = args.steps
    t0 = time.perf_counter()
    for _ in range(n):
        state = model(state)
    _sync(args.device)
    t = (time.perf_counter() - t0) / n
    _require_finite(state.dyn.theta_p, "theta_p")
    return {"t": t, "window_ms": [1e3 * t], "alive": float((state.aero.num > 0).sum()),
            "cells": args.nx * args.ny * args.nz, **meter.report()}


WORKERS = {"dycore": worker_dycore, "coupled": worker_coupled, "cares": worker_cares}


def _tail(text: str, n: int = 20) -> str:
    return " | ".join(text.strip().splitlines()[-n:])


class WorkerFailed(RuntimeError):
    """A worker failed other than by running out of device memory."""


OOM_MARKS = ("OutOfMemoryError", "CUDA out of memory")


def _spawn(worker, extra, device, timeout=1200, root=ROOT):
    """Run one measurement in a fresh process from the checkout at ``root``
    and return its parsed JSON.  A worker whose stderr names running out
    of device memory gives None (its return code and stderr tail printed),
    so that a sweep can try its next point; any other failure, or
    outliving ``timeout`` s, raises :class:`WorkerFailed` with the tail."""
    cmd = [sys.executable, "-m", "wrf_partmc_tpu_torch.bench", "--worker", worker,
           "--device", device, *extra]
    label = f"[bench] {worker} {' '.join(extra)}"
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=root)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else (e.stderr or "")
        raise WorkerFailed(f"{label}: killed after {timeout} s; stderr: {_tail(err)}")
    if p.returncode == 0:
        for line in reversed(p.stdout.strip().splitlines()):
            if line.startswith("{"):
                try:
                    res = json.loads(line)
                except json.JSONDecodeError:
                    continue
                print(f"{label}: {line}", flush=True)
                return res
    msg = f"{label}: failed, return code {p.returncode}; stderr: {_tail(p.stderr)}"
    if p.returncode != 0 and any(m in p.stderr for m in OOM_MARKS):
        print(msg, flush=True)
        return None
    raise WorkerFailed(msg)


def _args(**kw) -> list:
    return [a for k, v in kw.items() for a in (f"--{k}", str(v))]


def _extras(prefix: str, r: dict) -> dict:
    return {f"{prefix}_peak_gib": r["peak_gib"], f"{prefix}_window_ms": r["window_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="full", choices=["tiny", "full"])
    ap.add_argument("--worker", default=None, choices=sorted(WORKERS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=0)
    ap.add_argument("--ny", type=int, default=0)
    ap.add_argument("--nz", type=int, default=0)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--n_part", type=int, default=0)
    ap.add_argument("--cap", type=int, default=0)
    ap.add_argument("--chem", type=int, default=0)
    ap.add_argument("--n_sources", type=int, default=0)
    args = ap.parse_args(argv)

    if args.worker:
        print(json.dumps(WORKERS[args.worker](args)))
        return 0
    try:
        _sweep(args)
    except WorkerFailed as e:
        print(f"[bench] {e}", file=sys.stderr, flush=True)
        return 1
    return 0


def _sweep(args) -> None:
    """The preset's points, each in its own worker; prints the result line."""
    device = args.device
    if args.preset == "tiny":
        dyc_dims = (32, 32, 8)
        cpl = (12, 12, 4, 32, 96)
        n_dyc, n_cpl = 5, 5
    else:
        dyc_dims = (128, 128, 40)
        cpl = (40, 40, 10, 1000, 1280)   # em_uniform reference problem
        n_dyc, n_cpl = 10, 10

    # --- solve_em-equivalent dycore throughput (own process) ---
    r = _spawn("dycore", _args(nx=dyc_dims[0], ny=dyc_dims[1], nz=dyc_dims[2],
                               steps=n_dyc), device)
    if r is None:
        raise WorkerFailed("the dycore point ran out of device memory")
    t_d, dev = r["t"], r["device"]
    gp = dyc_dims[0] * dyc_dims[1] * dyc_dims[2]
    gps = gp * n_dyc / t_d

    # --- coupled em_uniform problem: walk the reference's particle-count
    # sweep {1000, 500, 200, 100}/cell until one fits the card's memory ---
    nx, ny, nz, n_part0, cap0 = cpl
    rc = None
    for n_try in (n_part0, n_part0 // 2, n_part0 // 5, n_part0 // 10):
        n_p = max(n_try, 8)
        cp = max(int(cap0 * n_try / n_part0), 16)
        rc = _spawn("coupled", _args(nx=nx, ny=ny, nz=nz, steps=n_cpl, n_part=n_p,
                                     cap=cp), device)
        if rc is not None:
            n_part = n_p
            break
    if rc is None:
        raise WorkerFailed("every coupled sweep point ran out of device memory")
    t_c = rc["t"]
    cells = nx * ny * nz
    cell_steps = cells * n_cpl / t_c
    parts = rc["alive"]
    part_steps = parts * n_cpl / t_c
    coag_pairs = cells * (rc["cap"] // 2) * n_cpl / t_c

    # --- chemistry-on coupled figure (CBM-Z + ASTEM, partmc_chem_dt=300 s) ---
    chem_extra = {}
    for n_try in (min(n_part, 100), 50, 20):
        n_p = max(n_try, 8)
        cp = max(int(cap0 * n_try / n_part0), 16)
        rch = _spawn("coupled", _args(nx=nx, ny=ny, nz=nz, steps=n_cpl, n_part=n_p,
                                      cap=cp, chem=1), device)
        if rch is not None:
            t_ch = rch["t"]
            chem_extra = {
                "coupled_chem_on_cell_steps_per_s": round(cells * n_cpl / t_ch, 1),
                "coupled_chem_on_steps_per_s": round(n_cpl / t_ch, 3),
                "coupled_chem_on_particles_per_cell": n_p,
                "coupled_chem_on_alive_particles": int(rch["alive"]),
                **_extras("coupled_chem_on", rch),
            }
            break

    # --- CARES-width weight-class universe (~40 classes): the same
    # em_uniform problem with a 38-source universe ---
    wide_extra = {}
    for n_try in (n_part, n_part // 2, n_part // 5):
        n_p = max(n_try, 8)
        cp = max(int(cap0 * n_try / n_part0), 16)
        rw = _spawn("coupled", _args(nx=nx, ny=ny, nz=nz, steps=n_cpl, n_part=n_p,
                                     cap=cp, n_sources=38), device)
        if rw is not None:
            t_w = rw["t"]
            wide_extra = {
                "coupled_40class_cell_steps_per_s": round(cells * n_cpl / t_w, 1),
                "coupled_40class_particles_per_cell": n_p,
                "coupled_40class_vs_8class_step_ratio": round(
                    (t_w / n_cpl) / (t_c / n_cpl), 3) if n_p == n_part else None,
                **_extras("coupled_40class", rw),
            }
            break

    # --- CARES-shaped end-to-end run: the full CARES physics set, chemistry
    # on, open boundaries, at the largest grid of bench.py's list that runs
    # at 100 particles per cell ---
    cares_extra = {}
    if args.preset == "full":
        for (cnx, cny, cnz) in ((72, 72, 24), (64, 64, 28), (56, 56, 24),
                                (48, 48, 20)):
            rcs = _spawn("cares", _args(nx=cnx, ny=cny, nz=cnz, steps=5, n_part=100,
                                        cap=128), device, timeout=2400)
            if rcs is not None:
                cares_extra = {
                    "cares_shape_grid": f"{cnx}x{cny}x{cnz}",
                    "cares_shape_cells": rcs["cells"],
                    "cares_shape_steps_per_s": round(1.0 / rcs["t"], 4),
                    "cares_shape_cell_steps_per_s": round(rcs["cells"] / rcs["t"], 1),
                    "cares_shape_alive_particles": int(rcs["alive"]),
                    **_extras("cares_shape", rcs),
                }
                break

    result = {
        "metric": f"solve_em grid-points/s/chip ({dyc_dims[0]}x{dyc_dims[1]}x{dyc_dims[2]} live dynamics)",
        "value": round(gps, 1),
        "unit": "grid-points/s",
        "extra": {
            "device": dev,
            "dycore_steps_per_s": round(n_dyc / t_d, 3),
            **_extras("dycore", r),
            "coupled_em_uniform_cell_steps_per_s": round(cell_steps, 1),
            "coupled_num_particles_per_cell": n_part,
            "coupled_em_uniform_steps_per_s": round(n_cpl / t_c, 3),
            "particle_steps_per_s": round(part_steps, 1),
            "coag_pair_evals_per_s": round(coag_pairs, 1),
            "alive_particles": int(parts),
            **_extras("coupled_em_uniform", rc),
            **chem_extra,
            **wide_extra,
            **cares_extra,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
