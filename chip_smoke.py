#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line and each fatal on failure:

1. the card: its name and power limit (nvidia-smi);
2. build: compile the hand-written CUDA kernels from ``wrf_partmc_tpu_torch/csrc``;
3. kernels: the launch floor (an empty kernel), then each kernel against
   its plain PyTorch version on the card, at the shapes of the em_uniform
   main path, with its time, its call time, the plain version's time, the
   library call's (K1 ``torch.linalg.solve`` on the dense system, K2
   ``torch.scatter``, K3 ``torch.gather``) and its bound (the least time
   for the bytes these inputs need at 3.35 TB/s, or for the operations at
   67 TFLOP/s, whichever is larger).  The call time of every kernel is the
   host clock over many wrapper calls ending in a synchronize, per call.
   K4 (``threefry_draw``, every bulk random draw) is held in each mode at
   the particle draws' [10, 40, 40, 1280], bit for bit against its plain
   version on the card and on the CPU, timed like K1 (its bound: the bytes
   it writes, or its int32, float32 and float64 operations at their peaks);
   K5 (``mie_fit_bulk``, the CARES step's aerosol optics) at the CARES
   shape's [124416, 128] slots and four bands on random populations of the
   path's sizes and indices, each sum within 2e-5 of its cell's extinction
   sum (``k5_hold``), timed like K1, its library call the plain version's
   [N, 60] @ [60, 45] ``torch.matmul`` alone and its bound the bytes or
   its float32 multiply-adds (``benchmark/roofline.py``'s ``k5_bound``);
   K6 (``move_ranks_cuda``, the transport's move draw, open-edge drop and
   class ranks) at the em_uniform [10, 40, 40, 1280] and CARES
   [24, 72, 72, 128] slots, bit for bit against the plain chain, timed like
   K1, its library yardstick the ranks from a stable ``torch.sort`` and
   its bound the bytes (``k6_bound``);
   The kernel times come from two methods: K1's is device time per launch
   from a CUDA graph of 100 wrapper calls replayed between two events (the
   replays read the same inputs, so below the 50 MB L2 they come from L2:
   every K1 shape but the CARES vertical diffusion and gas solve); K2's and
   K3's is the median of single wrapper calls between two events, host
   work included;
4. card against CPU: one coupled step at 12x12x4 on ``cuda`` and on ``cpu``
   from the same state;
5. main path: the em_uniform coupled step at 40x40x10 cells, 1000 particles
   per cell (capacity 1280), chemistry off: one warm-up step and six timed
   steps (one full coagulation cadence), with every kernel's launch count,
   then the synced draws (``draw_split``): two steps with every bulk draw
   between two synchronizes through K4, and two through the plain version
   called explicitly, each with its draws' ms and share of the step (also
   on paths 7, 11 and 28, on every rank);
6. card against CPU, chemistry on: the CBM-Z rate coefficients (the
   subnormal-prefactor DMS rate against float64), then one chem-on coupled
   step (77-gas CBM-Z + MOSAIC, 0.2 ppb DMS) at 12x12x4, chem_dt 60 s, on
   ``cuda`` and on ``cpu``;
7. chem-on main path: 40x40x10, 100 particles per cell (capacity 128),
   chem_dt 300 s: a warm-up step (step 0, chemistry) and 30 timed steps
   (steps 1-30, one chemistry macro-step), with every kernel's launch count;
8. the chemistry macro-step alone at full width, split into CBM-Z (rate
   coefficients, Jacobian, fast_inv, substeps), ASTEM and SOA;
9. the 40-class universe: two steps at 40x40x10, 1000 per cell,
   ``n_sources=38``, chemistry off, with every kernel's launch count;
10. card against CPU, the CARES shape: one step at 12x10x8 (open
    boundaries, MYJ, Morrison, Grell, correlated-k radiation with the
    aerosol optics, Noah, chemistry on) on ``cuda`` and on ``cpu``, K5
    launched once on the card and held at its shape;
11. the CARES path: 72x72x24, 100 particles per cell (capacity 128),
    dt 30 s, chem_dt 300 s: a warm-up step (step 0, chemistry) and 20
    timed steps (two chemistry macro-steps), with every kernel's launch
    count, overall and per caller (K5 in the optics); then the synced
    draws, the synced optics (``optics_split``: two steps with the optics
    and its sums between synchronizes through K5, two through the plain
    version, with the optics' own peak memory; K5 held on the path's own
    population) and a synced split of every section over one chemistry
    cadence, 10 steps (``synced_split`` with ``cares_split_sites``);
12. card against CPU, the diagnostics: ``diagnostics.process`` (advanced
    on, 100 bins) at 12x12x4 with one cell emptied;
13. the ideal cases: each of ``run.CASES`` built by ``run.build_model`` on
    ``cuda`` (20x20x10, 100 per cell) and stepped twice;
14. the runner path: ``run.main`` on a namelist written under ``build/``
    at the em_uniform width (40x40x10, 1000 per cell, capacity 1280, live
    dynamics, emission, coagulation, deposition, transport, removal
    counters and coagulation records), 12 steps with history and auxhist2
    every 6 and npz and NetCDF restarts at step 6: the files against the
    JAX writer's variables and shapes, chi in [0, 1], the counters finite,
    the aero_removed rows, the section timers, the same model stepped bare,
    and each writer timed alone with its file's size;
15. resume: from the step-6 npz and NetCDF restarts for 6 steps each, each
    final state bit-equal to the continuous run's;
16. card against CPU, the two option sets (``option_sets.OPTION_SETS``): one mesoscale
    step (YSU, slab LSM, radiation, WSM5, BMJ, sea salt) at 12x12x4 and one
    LES step (prognostic TKE, NBA, WENO5/3, Kessler) at 12x12x8;
17. the mesoscale options path: 40x40x10, 1000 particles per cell
    (capacity 1280), a warm-up and six timed steps with every kernel's
    launch count, then two steps of a synced split (each section between
    two ``torch.cuda.synchronize()``), the sea salt added per level, the
    BMJ rain and the WSM5 ice and snow;
18. the LES options path: 40x40x16 at 1000 per cell, the same report with
    the TKE, w and theta' ranges in place of the mesoscale physics;
19. the cost of ``rng.normal``'s float32 erfinv (``rng.erfinv_xla``): at
    each draw shape the paths 5, 11, 17 and 18 made, the card's draw equal
    to the CPU's bit for bit, its call time against the same draw through
    ``torch.erfinv``, and the difference a step;
20. card against CPU, the file-driven build: the inputs written under
    ``build/`` by the port's tools at 12x12x4, then ``run.build_model``
    with wrfinput + ics + emissions + bcs, and with a ``.spec`` scenario,
    on ``cuda`` and on ``cpu``: the initial states and one step of each;
21. the real-data path at the runner's width: the inputs written by the
    port's tools at 40x40x10 (``write_wrfinput`` with the Lambert
    projection and the 300 m hill, ``write_ics`` with a two-mode per-level
    dist, ``convert_smoke`` on a SMOKE file, ``run_mozbc`` on
    ``write_synthetic_mozart``), each tool timed, then ``run.main`` with
    --wrfinput --ics --emissions --bcs for 12 steps at 1000 per cell
    (history and auxhist2 every 6, no restart before the final one): the
    ``coupled_step`` ms/step, peak memory, launches by caller, finite
    fields with max |w| under 5 m/s, and the represented number at the
    start against the ICs' ``dist_number_conc``;
22. the ``.spec`` path: ``run.main(["--spec", ...])`` on a scenario of two
    height slabs with 24 hourly emission rows, at the same width for 6
    steps, with the same report; each level's initial number and O3 must
    be its slab's;
23. K2 through ``aero_state.compact`` on phase 21's final population
    ([16000, 33, 1280]): every field bit-equal to the plain version, with
    the kernel, call, plain, library and bound times;
24. the urban plume: the port's ``tools/urban_plume.py`` (P = 2048,
    n_ideal = 1024) through ``box_model.run_box`` for the published 24 h
    at dt 300 s on ``cuda``: hourly O3, NO, NH3, number and chi, the
    ms/step, K3's launches and shapes, and the trajectory bands of
    ``tests/test_urban_plume.py``;
25. card against CPU, the linear core: one em_uniform coupled step at
    12x12x4 with ``dyn_opt="linear"`` (no mu/ph) on ``cuda`` and on ``cpu``;
26. the linear-core path: 40x40x10, 1000 particles per cell (capacity
    1280), ``dyn_opt="linear"``: a warm-up and six timed steps, the ms/step,
    peak memory and each kernel's launches a step (K1 7 + 1: the linear
    acoustic's 1 + 2 + 4 substep solves and vertical diffusion);
27. card against CPU, the decomposed step: a world of one rank over NCCL
    on ``cuda:0`` against a world of one over gloo on ``cpu`` (the 1x1
    mesh: keys folded with the block index, the halos local copies), one
    step each of ``entry.build(mesh=...)`` at 12x12x4, of both option
    sets (``build_option_set(mesh=...)``: mesoscale 12x12x4, LES 12x12x8)
    and of the CARES shape at 12x10x8 (``build_cares_shape(mesh=...)``),
    compared as phases 4, 16 and 10; with more cards visible (up to 4),
    the same over ``factor_2d(n)`` ranks (``parallel.launch``), each
    rank's block compared (each CARES card rank launched K5 once, held at
    its block's shape).  Each card rank's block of every dycore field
    is then held against the same block of the undecomposed step on the
    card (bit-equal, or within 1e-4 of the field's scale, printed), and
    no step gathers a field;
28. the decomposed main path: 40x40x10 at 1000 per cell on the
    ``factor_2d(n)`` mesh of n ranks, n the visible cards up to 4 (one
    rank in this process, more through ``parallel.launch``): every rank
    holds and advances only its block of the Eulerian state and of the
    particles.  A warm-up and six timed steps, the ms/step against phase
    5's, peak memory, the collectives a step by kind with their bytes
    (the halo exchanges, their P2P sends; no all-gather), each kernel's
    launches a step and K1's by caller (the block's ARW acoustic and
    vertical diffusion), then a two-step synced split on every rank with
    the halo exchanges and the transport's P2P sends timed inside the
    sections, K1 held at the block shapes (with more than one rank also
    at the blocks of the CARES shape's 72x72x24) and K2 and K3 held and
    timed again at the rank-local rebucket's block shapes, then
    ``entry.dryrun_multichip(n)`` on the same world.  With more than one
    rank, the same at weak scaling: the (40 py)x(40 px)x10 domain, each
    rank's block the one-card main path's.  The process groups start on
    a file rendezvous under ``build/``.
30. the bench: ``python -m wrf_partmc_tpu_torch.bench --preset full`` in a
    process group of its own (each worker a fresh process: the dycore at
    128x128x40, em_uniform at 1000 per cell chemistry off, at 100 with
    chemistry on, at 1000 with 40 classes, the CARES shape at 72x72x24),
    its lines printed: exit 0, the first point of every sweep, every
    number finite and positive, the card and its power limit named, each
    worker's kernels launched (K5 in the CARES worker, at phase 11's
    shape); then the dycore worker's model built here
    and stepped twice, K1's launches counted and K1 held at its shapes;
31. the draws: K4's launches a step on every path, each path's synced
    draws (K4 and plain), and every draw each path made on the card by
    K4's argument key (mode, shape, range, block: recorded by
    ``record_draws`` around the path's counted steps) with its calls a
    step and that key's device, call, plain and bound times; each key is
    held against the plain draw on the card and on the CPU (after its
    path, or here).

Paths 5, 11, 17, 18, 21 and 22 also print their kernel launches by caller
(17, 18, 21 and 22 with K3 inside the particle rebalance and its
``split_largest``).

After each of the paths 5, 7, 9, 11, 13, 14, 17, 18, 21, 22, 24, 26, 28 and 30, every kernel (K4 at
each draw key) is held
against its plain version at each argument shape that path launched it with and no
earlier check held, with the same times.  K1 (``thomas_solve``: the
acoustic, MYJ and Noah solves, and vertical diffusion's six fields in one
launch) is held bit for bit against the plain recurrence field by field.
Paths 5 and 11 also keep
the index arrays their first transport and coagulation steps gave K2 and
K3; after each, both kernels run on those indices (bit-exact against the
plain version) with the share of rows that move, the times and the bound
for those indices.

The line before the last is the kernel summary as JSON, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no result.

    python3 chip_smoke.py --decomposed

runs only phases 1, 2, 5, 27, 28, 29 and 31, with their kernel holds: the
decomposition on every visible card (up to 4) against the undecomposed
main path, for a machine of several cards (the strong- and weak-scaling
ms/step beside phase 5's, the per-rank split, the P2P calls and bytes a
step and the peak memory a card), then

29. the option sets and the CARES shape decomposed on the visible cards:
    mesoscale at 40x40x10 and LES at 40x40x16 (1000 per cell, capacity
    1280), the CARES shape at 72x72x24 (100 per cell, capacity 128)
    strong and, with more than one card, weak at (72 py)x(72 px)x24, each
    beside the same path undecomposed on one card in the same call: a
    warm-up and six timed steps, the peak memory a card of the build and
    of the steps, the collectives a step with their bytes, each kernel's
    launches a step and by caller, a two-step synced split per rank with
    the halo exchanges timed inside; the CARES strong run's dycore blocks
    after one step against the one-card step's.  Every kernel is then
    held at the shapes these paths launched (K1 on the blocks' columns,
    K2 and K3 at the rank-local shapes, K5 at the CARES blocks' shapes).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

from benchmark import roofline

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()       # reset by main; the path lines print the time since


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def graph_ms(fn, calls: int = 100, reps: int = 5) -> float:
    """Device time per call of ``fn()`` in ms: ``calls`` calls captured once
    in a CUDA graph, replayed between two events (median of ``reps``
    replays, after a warm-up), divided by ``calls``.  The host's work in
    ``fn`` is not in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    del g
    return statistics.median(times)


def call_ms(fn, calls: int = 100) -> float:
    """Host clock per call of ``fn()`` in ms over ``calls`` calls ending in
    a synchronize (after a warm-up): what a caller waits for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def cuda_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def phase_card():
    import torch

    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def phase_build():
    from wrf_partmc_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    info = _cuda.build_info
    print(f"[build] {time.perf_counter() - t0:.3f} s total, nvcc "
          f"{info['seconds']:.3f} s, {os.path.relpath(info['path'], ROOT)}")
    entry = "?"
    for line in info.get("ptxas", "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"[build] ptxas {entry}: {line.strip()}")


def _rand_unique_dst(gen, C, L1, L2, drop_frac, device):
    """Per-row unique destinations in [0, L2) for min(L1, L2) rows, -1
    elsewhere and for a random drop_frac of rows."""
    import torch

    n = min(L1, L2)
    keys = torch.rand((C, L2), generator=gen, device=device)
    perm = torch.argsort(keys, dim=1)[:, :n].to(torch.int32)
    dst = torch.full((C, L1), -1, dtype=torch.int32, device=device)
    dst[:, :n] = perm
    drop = torch.rand((C, L1), generator=gen, device=device) < drop_frac
    return torch.where(drop, -1, dst).contiguous()


def _kernel_fns():
    from wrf_partmc_tpu_torch.ops import mie_fit, moves, place, threefry, tridiag

    return {"thomas_solve": tridiag.thomas_solve,
            "scatter_rows": place.scatter_rows_cuda,
            "gather_rows": place.gather_rows_cuda,
            "threefry_draw": threefry.threefry_draw,
            "mie_fit_bulk": mie_fit.mie_fit_bulk,
            "move_ranks": moves.move_ranks_cuda}


# kernels that only the paths with the aerosol optics launch (CARES and its
# blocks): K5
OPTICS_KERNELS = ("mie_fit_bulk",)


def reset_counts():
    for fn in _kernel_fns().values():
        fn.launches = 0
        fn.shapes = set()


def read_counts():
    """(launches, argument shapes) of each kernel since ``reset_counts``."""
    fns = _kernel_fns()
    return ({k: fn.launches for k, fn in fns.items()},
            {k: set(fn.shapes) for k, fn in fns.items()})


def _coefs(gen, dl_s, d_s, du_s):
    """Random diagonals: off-diagonals in [-1, 1), main diagonal
    4 + |N(0, 1)|, so every column is diagonally dominant."""
    import torch

    off = lambda sh: 2.0 * torch.rand(sh, generator=gen, device="cuda") - 1.0
    return off(dl_s), 4.0 + torch.randn(d_s, generator=gen, device="cuda").abs(), off(du_s)


DENSE_LIMIT = 4e9           # bytes of the dense batch torch.linalg.solve may take


def _dense(dl, d, du):
    """The dense [m, n, n] matrices of [n, m] diagonals (dl[0], du[n-1]
    dropped), or None above DENSE_LIMIT."""
    import torch

    n, m = d.shape
    if 4.0 * m * n * n > DENSE_LIMIT:
        return None
    A = torch.zeros((m, n, n), device=d.device)
    k = torch.arange(n, device=d.device)
    A[:, k, k] = d.T
    A[:, k[1:], k[:-1]] = dl[1:].T
    A[:, k[:-1], k[1:]] = du[:-1].T
    return A


def library_ms(A, B, X):
    """``torch.linalg.solve(A, B)`` (checked against X to 1e-4 of its
    largest value), timed with events around 5 calls after a warm-up; None
    where A is None."""
    import torch

    if A is None:
        return None
    X_l = torch.linalg.solve(A, B)
    rel = float((X_l - X).abs().max()) / float(X.abs().max())
    require(rel <= 1e-4, f"K1 library call disagrees: rel {rel}")
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(5):
        torch.linalg.solve(A, B)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / 5


def _columns(f, n, m):
    """A field [n, *cols] or [L, n, *cols] as [m, n, L]."""
    return f.reshape(-1, n, m).permute(2, 1, 0)


def check_thomas(gen, shapes):
    """K1 (``thomas_solve``, one launch for all the fields) against
    ``solve_fields_scan`` (solve_scan field by field) on random inputs with
    the argument shapes of a launch, (dl, d, du, fields, cols), bit for
    bit.  The bound reads dl, d, du and every field once and writes every
    solution once; its operations are 9 per unknown (7 in the forward
    sweep, 2 back).  The library call is one ``torch.linalg.solve`` of the
    dense [m, n, n] matrices against all the fields' columns as right-hand
    sides [m, n, sum L] (assembled outside the timed window; null above
    4 GB)."""
    import math

    import torch

    from wrf_partmc_tpu_torch.ops import tridiag

    dl_s, d_s, du_s, f_s, cols = shapes
    dl, d, du = _coefs(gen, dl_s, d_s, du_s)
    fields = [torch.randn(s, generator=gen, device="cuda") for s in f_s]
    run = lambda: tridiag.thomas_solve(dl, d, du, fields, cols)
    xs = run()
    refs = tridiag.solve_fields_scan(dl, d, du, fields)
    torch.cuda.synchronize()
    err = max(float((x - r).abs().max()) for x, r in zip(xs, refs))
    require(all(torch.equal(x, r) for x, r in zip(xs, refs)),
            f"K1 at fields {f_s} not bit-exact: max abs err {err}")
    n, m = d_s[0], math.prod(cols)
    flat = lambda a: a.expand(n, *cols).reshape(n, m)
    A = _dense(flat(dl), flat(d), flat(du))
    B = torch.cat([_columns(f, n, m) for f in fields], dim=2)
    X = torch.cat([_columns(x, n, m) for x in xs], dim=2)
    res = dict(max_abs_err=err, ms=graph_ms(run), call_ms=call_ms(run),
               plain_ms=graph_ms(lambda: tridiag.solve_fields_scan(dl, d, du, fields),
                                 calls=20),
               library_ms=library_ms(A, B, X))
    del A, B, X
    n_f = sum(math.prod(s) for s in f_s)
    res["bound_ms"], res["bound_by"] = roofline.k1_bound(
        sum(math.prod(s) for s in (dl_s, d_s, du_s)), n_f)
    lib = "null" if res["library_ms"] is None else f"{res['library_ms']:.4f} ms"
    print(f"[kernels] K1 thomas_solve coefficients {list(d_s)} fields "
          + " ".join(str(list(s)) for s in f_s)
          + f": max_abs_err {err:.3e}; device {res['ms']:.4f} ms, call {res['call_ms']:.4f} "
          f"ms, plain {res['plain_ms']:.4f} ms, library {lib}, bound {res['bound_ms']:.6f} ms "
          f"({res['bound_by']}), share {res['bound_ms'] / res['ms']:.3f}")
    return res


def launch_floor():
    """Device and call time of one launch of an empty kernel through the
    same binding, by the methods K1 is timed with."""
    from wrf_partmc_tpu_torch.ops import _cuda

    def empty():
        _cuda.check(_cuda.lib().wpt_empty_kernel(_cuda.stream_ptr(0)), "empty kernel")
    res = dict(ms=graph_ms(empty), call_ms=call_ms(empty))
    print(f"[kernels] launch floor (empty kernel): device {res['ms']:.4f} ms, call "
          f"{res['call_ms']:.4f} ms")
    return res


def moved_rows(dst, L2) -> int:
    """The rows K2 moves: those with a dst in [0, L2)."""
    return int(((dst >= 0) & (dst < L2)).sum())


def distinct_rows(src, L1) -> int:
    """The source rows K3 reads: the distinct src values in [0, L1) of each
    cell."""
    import torch

    C = src.shape[0]
    valid = (src >= 0) & (src < L1)
    hit = torch.zeros((C, L1 + 1), dtype=torch.bool, device=src.device)
    hit.scatter_(1, torch.where(valid, src, L1).long(), True)
    return int(hit[:, :L1].sum())


def time_scatter(x, dst, L2, label):
    """K2 against scatter_rows_plain, bit for bit, then the kernel, the
    plain version and the library call timed on the same inputs.  The
    library call is one ``torch.scatter`` of x into a zeroed [C, CH, L2+1]
    buffer with dropped rows sent to the spare slot L2; the buffer and the
    int64 index (an expanded view) are made outside the timed window."""
    import torch

    from wrf_partmc_tpu_torch.ops import place

    C, CH, L1 = x.shape
    out_k = place.scatter_rows_cuda(x, dst, L2)
    out_p = place.scatter_rows_plain(x, dst, L2)
    torch.cuda.synchronize()
    require(torch.equal(out_k, out_p), f"K2 scatter {label} not bit-exact")
    err = float((out_k - out_p).abs().max())
    del out_k, out_p
    zeros = torch.zeros((C, CH, L2 + 1), device=x.device)
    idx = torch.where((dst >= 0) & (dst < L2), dst, L2).long()[:, None, :].expand(C, CH, L1)
    out_l = torch.scatter(zeros, 2, idx, x)
    require(torch.equal(out_l[..., :L2], place.scatter_rows_plain(x, dst, L2)),
            f"K2 library call {label} disagrees")
    del out_l
    ms = cuda_ms(lambda: place.scatter_rows_cuda(x, dst, L2))
    cms = call_ms(lambda: place.scatter_rows_cuda(x, dst, L2), calls=20)
    pms = cuda_ms(lambda: place.scatter_rows_plain(x, dst, L2))
    lms = cuda_ms(lambda: torch.scatter(zeros, 2, idx, x))
    moved = moved_rows(dst, L2)
    bms, by = roofline.scatter_bound(C, CH, L1, L2, moved)
    share = moved / (C * L1)
    print(f"[kernels] K2 scatter_rows {label}: bit-exact, rows moved {share:.4f}; kernel "
          f"{ms:.4f} ms call {cms:.4f} ms plain {pms:.4f} ms library {lms:.4f} ms bound "
          f"{bms:.4f} ms ({by}) share of bound {bms / ms:.3f}")
    return dict(max_abs_err=err, ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by=by, moved=share)


def time_gather(x, src, label):
    """K3 against gather_rows_plain, bit for bit, then the kernel, the plain
    version and the library call timed on the same inputs.  The library
    call is one ``torch.gather`` from x padded with a zero slot at L1, with
    empty rows pointed there; the padded copy and the int64 index (an
    expanded view) are made outside the timed window."""
    import torch

    from wrf_partmc_tpu_torch.ops import place

    C, CH, L1 = x.shape
    L2 = src.shape[1]
    out_k = place.gather_rows_cuda(x, src)
    out_p = place.gather_rows_plain(x, src)
    torch.cuda.synchronize()
    require(torch.equal(out_k, out_p), f"K3 gather {label} not bit-exact")
    err = float((out_k - out_p).abs().max())
    del out_k
    xp = torch.cat([x, torch.zeros((C, CH, 1), device=x.device)], dim=2)
    idx = torch.where((src >= 0) & (src < L1), src, L1).long()[:, None, :].expand(C, CH, L2)
    require(torch.equal(torch.gather(xp, 2, idx), out_p), f"K3 library call {label} disagrees")
    del out_p
    ms = cuda_ms(lambda: place.gather_rows_cuda(x, src))
    cms = call_ms(lambda: place.gather_rows_cuda(x, src), calls=20)
    pms = cuda_ms(lambda: place.gather_rows_plain(x, src))
    lms = cuda_ms(lambda: torch.gather(xp, 2, idx))
    rows = distinct_rows(src, L1)
    bms, by = roofline.gather_bound(C, CH, L1, L2, rows)
    share = rows / (C * L1)
    print(f"[kernels] K3 gather_rows {label}: bit-exact, source rows read {share:.4f}, "
          f"output rows filled {float(((src >= 0) & (src < L1)).float().mean()):.4f}; "
          f"kernel {ms:.4f} ms call {cms:.4f} ms plain {pms:.4f} ms library {lms:.4f} ms "
          f"bound {bms:.4f} ms ({by}) share of bound {bms / ms:.3f}")
    return dict(max_abs_err=err, ms=ms, call_ms=cms, plain_ms=pms, library_ms=lms,
                bound_ms=bms, bound_by=by, moved=share)


def check_scatter(gen, shapes):
    """K2 on a random payload of ``shapes[0]`` into ``shapes[1]`` slots,
    with unique destinations for min(L1, L2) rows and a tenth of them
    dropped."""
    import torch

    x_shape, L2 = shapes
    C, CH, L1 = x_shape
    x = torch.randn(x_shape, generator=gen, device="cuda")
    dst = _rand_unique_dst(gen, C, L1, L2, 0.1, x.device)
    return time_scatter(x, dst, L2, f"{list(x_shape)}->{L2}")


def check_gather(gen, shapes):
    """K3 from a random payload of ``shapes[0]`` into ``shapes[1]`` slots,
    sources drawn uniformly from [-1, L1) (empty rows and duplicates)."""
    import torch

    x_shape, L2 = shapes
    C, CH, L1 = x_shape
    x = torch.randn(x_shape, generator=gen, device="cuda")
    src = torch.randint(-1, L1, (C, L2), generator=gen, device="cuda", dtype=torch.int32)
    return time_gather(x, src, f"{list(x_shape)}->{L2}")


# K4's least work (``roofline.k4_bound``), counted from csrc/threefry.cu:
# the hash is 74 int32 operations an element (the counter split, two key
# adds, 20 rounds of add, rotate and xor, 10 injection adds, the output
# xor); a block draw's index 11 more (three divisions, three remainders,
# five multiply-adds); the uniform 2 int32 (shift, or) and 4 float32
# (subtract, multiply, add, clamp).  The normal adds 6 float32 and 16
# float64 (eight emulated fused multiply-adds) in erfinv, one float64 root
# where w >= 5, and its log1p either 7 float32 and 28 float64 (the rational,
# |u^2| below sqrt(2) - 1) or 4 int32, 12 float32 and 20 float64 (the log).
# Rates: float32 67e12 (FP32_OPS_PER_S), float64 34e12 (NVIDIA's data sheet,
# outside the tensor cores), int32 33.5e12 (132 SMs x 128 lanes at the 1.98
# GHz that gives the float32 figure, one operation a lane and clock: Hopper
# issues integer adds to its FMA lanes as well, and a first count at 64
# int32 lanes an SM put the measured kernel below that bound).  Bound: the
# larger of the bytes written at 3.35 TB/s and the slowest unit's share of
# the operations these inputs need (each unit at its peak, all at once).
K4_TIMES = {}                # K4 argument key -> its check's result


def normal_branches(u) -> tuple:
    """(n_small, n_ge5) of a normal draw from its uniform ``u``: the
    elements whose log1p takes the rational (u*u below sqrt(2) - 1), and
    those with -log1p(-u*u) >= 5; (0, 0) without ``u``."""
    import torch

    if u is None:
        return 0, 0
    a = (u.double() * u.double())
    return int((a < 0.41421356237309504880).sum()), int((-torch.log1p(-a) >= 5.0).sum())


def check_threefry(gen, shapes):
    """K4 (``threefry_draw``) at one argument key (mode, shape, lo, span,
    block arguments) under the key of seed 12345: bit for bit against its
    plain version (``rng.draw_plain``) on the card and against the plain
    draw on the CPU; device time (a CUDA graph of wrapper calls), call time,
    the plain version's call time and the bound.  No library call computes
    this function."""
    import math

    import torch

    from wrf_partmc_tpu_torch.ops import threefry
    from wrf_partmc_tpu_torch.utils import rng

    mode, shape, lo, span, blk = shapes
    k = rng.key(12345)
    block = None if blk is None else rng.Block(*blk[:6])
    run = lambda: threefry.threefry_draw(mode, k, shape, "cuda", lo, span, blk)
    got = run()
    plain = lambda: rng.draw_plain(mode, k, shape, "cuda", lo, span, block)
    want = plain()
    cpu = rng.draw_plain(mode, k, shape, "cpu", lo, span, block)
    bits = (lambda t: t.view(torch.int32)) if mode != "bits" else (lambda t: t)
    require(torch.equal(bits(got), bits(want)) and torch.equal(bits(got.cpu()), bits(cpu)),
            f"K4 {mode} {list(shape)} block {blk}: not bit-equal to the plain draw "
            f"(card {torch.equal(bits(got), bits(want))}, CPU "
            f"{torch.equal(bits(got.cpu()), bits(cpu))})")
    n = math.prod(shape)
    u = None
    if mode == "normal":
        u = rng.draw_plain("uniform", k, shape, "cuda", lo, span, block)
    del got, want, cpu
    big = n > 4_000_000
    res = dict(max_abs_err=0.0, ms=graph_ms(run, calls=20 if big else 100),
               call_ms=call_ms(run, calls=20 if big else 100),
               plain_ms=call_ms(plain, calls=3 if big else 20),
               library_ms=None)         # no PyTorch call draws threefry (torch.rand is Philox)
    res["bound_ms"], res["bound_by"] = roofline.k4_bound(mode, n, blk is not None,
                                                         *normal_branches(u))
    K4_TIMES[shapes] = res
    print(f"[kernels] K4 threefry_draw {mode} {list(shape)}"
          + ("" if blk is None else f" block {list(blk)}")
          + ("" if mode == "bits" else f" lo {lo!r} span {span!r}")
          + f": bit-equal to the plain draw on the card and on the CPU; device "
          f"{res['ms']:.4f} ms, call {res['call_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
          f"library null, bound {res['bound_ms']:.6f} ms ({res['bound_by']}), share "
          f"{res['bound_ms'] / res['ms']:.3f}")
    return res


K5_TOL = dict(rtol=2e-5, floor=1e-6)    # of the cell's extinction sum (k5_hold)
K5_CELL_AREA = 4000.0 * 4000.0          # the CARES cell's [m2]: tau = sum / area


def k5_inputs(gen, C: int, P: int):
    """diam, n, k, live number [C, P] on the card: diameters 1 nm to 10 um,
    n 1.33-1.82 and k 0 (30%) or 1e-3 to 0.74 (the port's species
    indices), 20% dead slots, the first cell empty."""
    import torch

    u = lambda lo, hi: lo + (hi - lo) * torch.rand((C, P), generator=gen, device="cuda")
    coin = lambda p: torch.rand((C, P), generator=gen, device="cuda") < p
    diam, n = 10.0 ** u(-9.0, -5.0), u(1.33, 1.82)
    k = torch.where(coin(0.3), 0.0, 10.0 ** u(-3.0, -0.13))
    num = torch.where(coin(0.8), u(1e6, 1e8), 0.0)
    num[0] = 0.0
    return diam, n, k, num


def k5_fields(sums):
    """(tauaer of a CARES cell, waer, gaer) from [3, W, C] sums, in float64."""
    s = sums.double()
    ext = s[0] + s[1]
    return (ext / K5_CELL_AREA, s[0] / ext.clamp(min=1e-30), s[2] / s[0].clamp(min=1e-30))


def k5_hold(tag: str, got, want) -> float:
    """K5's [3, W, C] sums against the plain version's: each sum within
    K5_TOL's rtol of its cell's extinction sum (c_sca + c_abs) num, with a
    floor of K5_TOL's floor of the largest, and so tauaer at K5_TOL.  Not
    of itself: q_sca = q_ext - q_abs cancels for small absorbing particles,
    so the last ulps of q_ext move c_sca and c_abs by a share of c_ext.
    This bounds waer's error by about twice the rtol.  Prints the largest
    errors of tauaer, waer and gaer and returns the largest of the three."""
    g, w = got.double(), want.double()
    ext = w[0] + w[1]
    lim = K5_TOL["rtol"] * ext + K5_TOL["floor"] * float(ext.max())
    for q, name in enumerate(("c_sca num", "c_abs num", "c_sca g num")):
        err = (g[q] - w[q]).abs()
        require(bool((err <= lim).all()), f"{tag}: the sum of {name} off by "
                f"{float(err.max()):.3e} (worst share of its bound "
                f"{float((err / lim.clamp(min=1e-300)).max()):.3f})")
    errs = {name: float((a - b).abs().max())
            for name, a, b in zip(("tauaer", "waer", "gaer"), k5_fields(got), k5_fields(want))}
    print(f"[kernels] {tag}: max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return max(errs.values())


def check_mie_fit(gen, shapes):
    """K5 (``mie_fit_bulk``) at (cells, slots, wavelengths) on the inputs of
    ``k5_inputs``: its sums against the plain version's
    (``optics.mie_fit_sums_plain``) by ``k5_hold``; device time (a CUDA graph of
    wrapper calls), call time, the plain version's call time, the library
    call's (the plain version's [N, 60] @ [60, 45] ``torch.matmul`` alone,
    a part of the function) and the bound."""
    import torch

    from wrf_partmc_tpu_torch.models.partmc import mie, optics
    from wrf_partmc_tpu_torch.ops import mie_fit

    C, P, wl = shapes
    W = len(wl)
    diam, n, k, num = k5_inputs(gen, C, P)
    coeffs = mie._fit_coeffs(diam.device)
    run = lambda: mie_fit.mie_fit_bulk(diam, n, k, num, coeffs, wl)
    plain = lambda: optics.mie_fit_sums_plain(diam, n, k, num, wl)
    got = run()
    torch.cuda.synchronize()
    err = k5_hold(f"K5 [{C},{P}] x {W} bands", got, plain())
    require(bool((got[:, :, 0] == 0.0).all()), f"K5 [{C},{P}]: the empty cell is not 0")
    del got
    big = C * P > 4_000_000
    res = dict(max_abs_err=err, ms=graph_ms(run, calls=10 if big else 100),
               call_ms=call_ms(run, calls=10 if big else 100),
               plain_ms=call_ms(plain, calls=2 if big else 10))
    T = torch.randn((C * P, mie._FIT_J), generator=gen, device="cuda")
    res["library_ms"] = cuda_ms(lambda: T @ coeffs, reps=5 if big else 10)
    del T
    res["bound_ms"], res["bound_by"] = roofline.k5_bound(C, P, W, int((num != 0).sum()))
    print(f"[kernels] K5 mie_fit_bulk [{C},{P}] x {W} bands: sums within "
          f"{K5_TOL['rtol']:g} of the cell's extinction, floor {K5_TOL['floor']:g} of the "
          f"largest (max abs err {err:.3e}); "
          f"device {res['ms']:.4f} ms, call {res['call_ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, library (the [N,60]@[60,45] matmul alone) "
          f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.6f} ms ({res['bound_by']}), "
          f"share {res['bound_ms'] / res['ms']:.3f}")
    return res


def k6_bound(n_class: int, shape) -> tuple:
    """(ms, "bytes") for K6 on [nz, ny, nx, P] slots: u, u2, num and
    w_class read and dcode and rank_p written once (24 bytes a slot), each
    cell's four face probabilities and R row per class read once and its
    [nz + 4] counts written once."""
    nz, ny, nx, P = shape
    cells = nz * ny * nx
    n_bytes = 24.0 * cells * P + 4.0 * cells * (n_class * (4 + nz) + nz + 4)
    return roofline.bound(n_bytes)


def sort_ranks(dcode, D: int):
    """The class ranks and counts from a stable ``torch.sort`` of the codes
    (the library yardstick of K6's ranks; the port never calls it)."""
    import torch

    C, P = dcode.shape
    codes, order = torch.sort(dcode, dim=-1, stable=True)
    first = torch.searchsorted(codes, codes)
    pos = torch.arange(P, device=dcode.device, dtype=torch.int64).expand(C, P)
    rank = torch.empty_like(order).scatter_(1, order, pos - first)
    rank = torch.where(dcode >= 0, rank, 0)
    cnt = torch.stack([(dcode == d).sum(-1) for d in range(D)], -1)
    return rank, cnt


def check_move_ranks(gen, shapes):
    """K6 (``move_ranks_cuda``) at (classes, slot shape, edges): four fifths
    of the slots alive, random classes, face probabilities and
    row-stochastic R; ``dcode``, ``rank_p`` and ``cnt`` bit for bit against
    the plain chain (``moves.move_ranks_plain``) on the card; device time (a
    CUDA graph of wrapper calls), call time, the plain chain's call time, the
    library yardstick (class ranks and counts from a stable ``torch.sort``
    of K6's codes, the ranks alone) and the bound."""
    import math

    import torch

    from wrf_partmc_tpu_torch.ops import moves

    n_class, shape, edges = shapes
    nz, ny, nx, P = shape
    edges = moves.Edges(*edges)
    r = lambda sh: torch.rand(sh, generator=gen, device="cuda")
    u, u2 = r(shape), r(shape)
    num = torch.where(r(shape) < 0.8, 1e6, 0.0)
    w_class = torch.randint(0, n_class, shape, generator=gen, device="cuda",
                            dtype=torch.int32)
    ph = [0.15 * r((n_class, nz, ny, nx)) for _ in range(4)]
    R = r((n_class, ny, nx, nz, nz))
    R_cum = torch.cumsum(R / R.sum(-1, keepdim=True), dim=-1)
    del R
    args = (u, u2, num, w_class, ph, R_cum, edges)
    run = lambda: moves.move_ranks_cuda(*args)
    plain = lambda: moves.move_ranks_plain(*args)
    got, want = run(), plain()
    torch.cuda.synchronize()
    for name, a, b in zip(("dcode", "rank_p", "cnt"), got, want):
        require(a.dtype == b.dtype and torch.equal(a, b),
                f"K6 {n_class} classes {list(shape)} {tuple(edges)}: {name} not bit-equal "
                "to the plain chain")
    dcode = got[0]
    lib_rank, lib_cnt = sort_ranks(dcode, nz + 4)
    require(torch.equal(lib_rank, got[1].long()) and torch.equal(lib_cnt.float(), got[2]),
            f"K6 {list(shape)}: the sorted ranks differ")
    del got, want, lib_rank, lib_cnt
    big = math.prod(shape) > 4_000_000
    res = dict(max_abs_err=0.0, ms=graph_ms(run, calls=20 if big else 100),
               call_ms=call_ms(run, calls=20 if big else 100),
               plain_ms=call_ms(plain, calls=3 if big else 10),
               library_ms=cuda_ms(lambda: sort_ranks(dcode, nz + 4), reps=5))
    res["bound_ms"], res["bound_by"] = k6_bound(n_class, shape)
    print(f"[kernels] K6 move_ranks {n_class} classes {list(shape)} edges {tuple(edges)}: "
          f"bit-equal to the plain chain; device {res['ms']:.4f} ms, call "
          f"{res['call_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, library (stable sort "
          f"ranks) {res['library_ms']:.4f} ms, bound {res['bound_ms']:.6f} ms "
          f"({res['bound_by']}), share {res['bound_ms'] / res['ms']:.3f}")
    return res


CHECKS = {"thomas_solve": check_thomas, "scatter_rows": check_scatter,
          "gather_rows": check_gather, "threefry_draw": check_threefry,
          "mie_fit_bulk": check_mie_fit, "move_ranks": check_move_ranks}
CHECKED = {k: set() for k in CHECKS}     # argument shapes already held


def hold(kernels: dict, gen, name: str, shapes):
    """Hold kernel ``name`` against its plain version at ``shapes``; the
    kernels line reports the largest error of all its checks."""
    res = CHECKS[name](gen, shapes)
    k = kernels[name]
    k["max_abs_err"] = max(k.get("max_abs_err", 0.0), res["max_abs_err"])
    if "ms" not in k:                 # the first hold's times until phase 3 names its own
        k.update({key: res[key] for key in KEYS})
    CHECKED[name].add(shapes)
    return res


KEYS = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")


def k1_shapes(coef, fields, cols=None):
    """K1's argument shapes (dl, d, du, fields, cols) as ``thomas_solve``
    records them: coefficients ``coef`` for all three diagonals."""
    return (coef, coef, coef, tuple(fields), tuple(coef[1:] if cols is None else cols))


def vdiff_shapes(nz, ny, nx, moist, chem):
    """K1's shapes in vertical diffusion's launch: u, v, theta', moist,
    chem and tke at nz levels over ny x nx columns, moist and chem stacked
    ``moist`` and ``chem`` deep."""
    one = (nz, ny, nx)
    return k1_shapes(one, (one, one, one, (moist, *one), (chem, *one), one))


# K6's argument keys (classes, slot shape, edges) at the em_uniform and
# CARES shapes
K6_EM_UNIFORM = (1, (10, 40, 40, 1280), (0, 0, 40, 40, False, False))
K6_CARES = (1, (24, 72, 72, 128), (0, 0, 72, 72, True, True))


def phase_kernels(kernels: dict):
    """Each kernel at the chem-off main path's shapes, with its times and
    bound for the kernel table (PERF.md)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels["thomas_solve"]["launch_floor"] = launch_floor()
    # K1: acoustic W'' solve (nz-1 = 9 faces x 1600 columns), the vdiff
    # launch of the six fields (moist 3 and chem 32 deep) on 10 levels, and
    # the CARES gases [24, 77, 72, 72] as one field against [24, 1, 72, 72]
    # coefficients read by column modulus (how vertical diffusion solved
    # them before its fields shared one launch)
    a = (9, 40, 40)
    k1 = [hold(kernels, gen, "thomas_solve", k1_shapes(a, [a])),
          hold(kernels, gen, "thomas_solve", vdiff_shapes(10, 40, 40, 3, 32)),
          hold(kernels, gen, "thomas_solve",
               k1_shapes((24, 1, 72, 72), [(24, 77, 72, 72)], (77, 72, 72)))]
    # K2/K3 at full width: C = 16000 cells, CH = 33 channels, P = 1280
    C, CH, P, F1, AB = 16000, 33, 1280, 1120, 400
    k2 = [hold(kernels, gen, "scatter_rows", ((C, CH, L1), L2))
          for L1, L2 in ((P, F1), (AB, AB))]
    k3 = [hold(kernels, gen, "gather_rows", ((C, CH, L1), P)) for L1 in (AB, P)]
    # K4: the particle draws' [10, 40, 40, 1280] in each mode (the path
    # draws uniforms at this shape; bits and normals at smaller ones)
    from wrf_partmc_tpu_torch.utils import rng

    ranges = {"bits": (0.0, 1.0), "uniform": (0.0, 1.0),
              "normal": (rng.NORMAL_LO, rng.NORMAL_SPAN)}
    k4 = [hold(kernels, gen, "threefry_draw", (mode, (10, 40, 40, P), *ranges[mode], None))
          for mode in ("uniform", "bits", "normal")]
    # K5: the CARES shape's 72x72x24 cells of 128 slots at the four bands
    from wrf_partmc_tpu_torch.models.partmc.optics import WAVELENGTHS

    k5 = [hold(kernels, gen, "mie_fit_bulk", (CARES_CELLS, 128, WAVELENGTHS))]
    # K6: the em_uniform transport's slots (periodic) and the CARES shape's
    # (open on both axes)
    k6 = [hold(kernels, gen, "move_ranks", K6_EM_UNIFORM),
          hold(kernels, gen, "move_ranks", K6_CARES)]
    for name, res, main in (("thomas_solve", k1, 1), ("scatter_rows", k2, 0),
                            ("gather_rows", k3, 0), ("threefry_draw", k4, 0),
                            ("mie_fit_bulk", k5, 0), ("move_ranks", k6, 0)):
        kernels[name].update({k: res[main][k] for k in KEYS})
    torch.cuda.empty_cache()


def phase_path_shapes(label: str, kernels: dict, shapes: dict):
    """Each kernel at every argument shape a path gave it (``read_counts``)
    that no earlier check held, against its plain version."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    new = {k: sorted(v - CHECKED[k], key=repr) for k, v in shapes.items()}
    print(f"[kernels] {label} (at {time.perf_counter() - T_START:.1f} s): shapes launched "
          + json.dumps({k: len(v) for k, v in shapes.items()})
          + ", not yet held " + json.dumps({k: len(v) for k, v in new.items()}))
    for name, todo in new.items():
        for sh in todo:
            hold(kernels, gen, name, sh)
            torch.cuda.empty_cache()


DYN_FIELDS = ("u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem",
              "num_conc", "tke")


def compare_card_cpu(tag: str, out_gpu, out_cpu, floor: float = 1e-4,
                     particle_rtol: float = 1e-4) -> str:
    """Hold a step on the card against the same step on the CPU: every dycore
    field by the rule of the CPU parity tests against the JAX package
    (tests/test_torch_coupled.py, tests/test_torch_chem_coupled.py): rtol
    1e-4, absolute floor ``floor`` of the field's scale, with roundoff-sized
    floors for w and ph in uniform flow; per cell the represented number and
    the per-species volume rtol ``particle_rtol`` (the latter with a floor of
    1e-6 of the largest).  Returns the differences as one line."""
    import torch

    floors = {"w": 1e-5, "ph": 1e-3}
    worst = {}
    for name in DYN_FIELDS:
        a, b = getattr(out_gpu.dyn, name), getattr(out_cpu.dyn, name)
        if b is None:                      # mu and ph on the linear core
            require(a is None, f"{tag}: dyn.{name} only on the card")
            continue
        atol = max(floors.get(name, 0.0), floor * float(b.abs().max()))
        worst[name] = float((a - b).abs().max())
        require(torch.allclose(a, b, rtol=1e-4, atol=atol),
                f"{tag}: dyn.{name} max diff {worst[name]}")
    num_g, num_c = out_gpu.aero.total_num(), out_cpu.aero.total_num()
    sv_g = torch.sum(out_gpu.aero.vol * out_gpu.aero.num[..., None, :], -1)
    sv_c = torch.sum(out_cpu.aero.vol * out_cpu.aero.num[..., None, :], -1)
    n_rel = float(((num_g - num_c).abs() / num_c.abs().clamp(min=1e-30)).max())
    v_floor = 1e-6 * float(sv_c.abs().max())
    big = sv_c.abs() > v_floor              # the relative rule's entries
    v_rel = float(((sv_g - sv_c).abs() / sv_c.abs())[big].max())
    v_abs = float((sv_g - sv_c).abs()[~big].max()) if bool((~big).any()) else 0.0
    require(n_rel <= particle_rtol, f"{tag}: per-cell number rel {n_rel}")
    require(torch.allclose(sv_g, sv_c, rtol=particle_rtol, atol=v_floor),
            f"{tag}: per-species volume rel {v_rel}, below the floor abs {v_abs}")
    return ("dyn max diffs " + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
            + f"; per-cell number max rel {n_rel:.2e}; per-cell species volume max "
            f"rel {v_rel:.2e} (above 1e-6 of the largest), max abs {v_abs:.2e} below "
            f"that floor of {v_floor:.2e}; alive {int(out_gpu.aero.n_alive().sum())} vs "
            f"{int(out_cpu.aero.n_alive().sum())}")


def phase_card_vs_cpu():
    from wrf_partmc_tpu_torch.entry import build

    model, state = build(12, 12, 4, n_part=16, cap=48, device="cpu")
    out_cpu = model(state)
    out_gpu = model.to("cuda")(state.to("cuda")).to("cpu")
    print("[card-vs-cpu] 12x12x4, 16/cell: "
          + compare_card_cpu("card vs CPU", out_gpu, out_cpu))


def drive(model, box: list, n_timed: int):
    """One warm-up step and ``n_timed`` timed steps, the kernels' counts set
    to 0 just before and read just after.  ``box`` is a list holding the
    initial state and no other reference to it: drive takes it out, so no
    state but the step's input and output is alive through the steps (the
    peak memory is the step's).  Returns (state, warm-up s, timed s,
    launches, argument shapes)."""
    import torch

    state = box.pop()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = model(state)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state = model(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (state, warm, dt, *read_counts())


def require_launched(kernels: dict, key: str, launches: dict, path: str, steps: int,
                     optics: bool = False):
    """Every kernel of the path launched (``OPTICS_KERNELS`` only where
    ``optics``); its count is printed with its launches a step over the
    ``steps``."""
    PATH_LAUNCHES[path] = (dict(launches), steps)
    on_path = [name for name in kernels if optics or name not in OPTICS_KERNELS]
    for name in on_path:
        kernels[name][key] = launches[name]
        require(launches[name] > 0, f"{name} was not launched on the {path}")
    print(f"[launches] {path}, {steps} steps: " + ", ".join(
        f"{name} {launches[name]} ({launches[name] / steps:g} a step)" for name in kernels))


def phase_main_path(kernels: dict, n_timed: int = 6):
    import torch

    from wrf_partmc_tpu_torch.entry import build

    t0 = time.perf_counter()
    model, state = build(40, 40, 10, n_part=1000, cap=1280, device="cuda")
    torch.cuda.synchronize()
    print(f"[main] build 40x40x10, 1000/cell, cap 1280: "
          f"{time.perf_counter() - t0:.3f} s, alive {int(state.aero.n_alive().sum())}")
    # step 0 coagulates, then steps 1..6, of which step 6 coagulates; step 0
    # leaves copies of its K2/K3 index arrays (outside the timed steps)
    by_caller, captured, draws = {}, {}, {}
    restore = attribute_launches(by_caller, captured)
    restore_draws = record_draws(draws)
    box, state = [state], None          # drive holds the only reference
    state, warm, dt, launches, shapes = drive(model, box, n_timed)
    restore_draws()
    restore()
    cells = 40 * 40 * 10
    ms = 1e3 * dt / n_timed
    DRAWS["main path"] = (draws, n_timed + 1, ms)
    PATH_MS["main path"] = ms
    alive = int(state.aero.n_alive().sum())
    print(f"[main] warm-up step {1e3 * warm:.3f} ms; {n_timed} timed steps "
          f"{1e3 * dt:.3f} ms = {ms:.3f} ms/step, {cells * n_timed / dt:.1f} "
          f"cell-steps/s; alive {alive}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {launches}; transport diag "
          + json.dumps({k: float(v) for k, v in model.last_diag.items()}))
    require(bool(torch.isfinite(state.dyn.theta_p).all()), "theta_p not finite")
    require(bool(torch.isfinite(state.aero.num).all()), "num not finite")
    require(tuple(state.aero.num.shape) == (10, 40, 40, 1280), "bad num shape")
    require(alive > 0, "no particle alive")
    require_launched(kernels, "launches", launches, "main path", n_timed + 1)
    print(f"[main] kernel launches by caller: {json.dumps(by_caller)}")
    draw_split("main path", model, state)
    return shapes, captured


def check_rates_on_card():
    """CBM-Z rate coefficients on the card against the CPU, day and night,
    rtol 1e-4; the DMS + OH addition rate, whose 1.7e-42 prefactor is a
    float32 subnormal, against its float64 formula to 5e-4 (the subnormal's
    11 bits), so a build that flushes subnormals fails here."""
    import numpy as np
    import torch

    from wrf_partmc_tpu_torch.models.partmc import cbmz

    rng = np.random.default_rng(0)
    T = rng.uniform(240.0, 310.0, 64).astype(np.float32)
    P = rng.uniform(5.0e4, 1.0e5, 64).astype(np.float32)
    RH = rng.uniform(0.2, 0.95, 64).astype(np.float32)
    mu = np.where(np.arange(64) % 2 == 0, 0.6, -0.2).astype(np.float32)
    i_dms = [i for i, f in enumerate(cbmz.build_mechanism().rate_fns)
             if f is cbmz.K_DMS_OH_ADD][0]
    k = {dev: cbmz.rate_coefficients(cbmz.build_mechanism(device=dev),
                                     *(torch.tensor(a, device=dev) for a in (T, P, RH, mu)))
         .cpu().numpy() for dev in ("cpu", "cuda")}
    rel = float((np.abs(k["cuda"] - k["cpu"]) / np.maximum(np.abs(k["cpu"]), 1e-38)).max())
    T64, P64 = T.astype(np.float64), P.astype(np.float64)
    M = P64 / (cbmz.c.BOLTZMANN * T64) * 1e-6
    o2 = 0.21 * M
    k64 = (1.7e-42 * np.exp(7810.0 / T64) * o2
           / (1.0 + 5.5e-31 * np.exp(7460.0 / T64) * o2)) * M * 1e-9
    dms_rel = float((np.abs(k["cuda"][:, i_dms] - k64) / k64).max())
    print(f"[card-vs-cpu-chem] rate coefficients, 64 cells x {k['cpu'].shape[1]} "
          f"reactions: card vs CPU max rel {rel:.2e}; DMS+OH addition (prefactor "
          f"1.7e-42) on the card vs float64 max rel {dms_rel:.2e}, min "
          f"{float(k['cuda'][:, i_dms].min()):.4e}")
    require(np.allclose(k["cuda"], k["cpu"], rtol=1e-4, atol=0.0),
            f"rate coefficients: card vs CPU max rel {rel}")
    require(dms_rel <= 5e-4, f"DMS+OH addition rate on the card: rel {dms_rel} "
            "against float64 (a flushed subnormal gives 1)")


def phase_card_vs_cpu_chem():
    import dataclasses

    import torch

    from wrf_partmc_tpu_torch.entry import build
    from wrf_partmc_tpu_torch.utils.at import set_at

    check_rates_on_card()
    model, state = build(12, 12, 4, n_part=16, cap=48, chem_on=True, chem_dt=60.0,
                         device="cpu")
    # 0.2 ppb of DMS, so the subnormal-prefactor channel runs in the step
    state = dataclasses.replace(state, gas=set_at(
        state.gas, model.gas_data.spec_by_name("DMS"), 0.2))
    out_cpu = model(state)                      # step 0 runs the chemistry
    out_gpu = model.to("cuda")(state.to("cuda")).to("cpu")
    moved = float((out_cpu.gas - state.gas).abs().max())
    require(moved > 1e-3, "card vs CPU, chem on: the chemistry did not run")
    # gases: rtol 1e-4 with a 1e-9 ppb floor, the rule of the CPU parity
    # test against the JAX package (tests/test_torch_chem_coupled.py)
    g_rel = float(((out_gpu.gas - out_cpu.gas).abs() / (out_cpu.gas.abs() + 1e-9)).max())
    require(torch.allclose(out_gpu.gas, out_cpu.gas, rtol=1e-4, atol=1e-9),
            f"card vs CPU, chem on: gases max rel {g_rel}")
    line = compare_card_cpu("card vs CPU, chem on", out_gpu, out_cpu)
    legs = bool(torch.equal(torch.where(out_gpu.aero.alive, out_gpu.aero.hyst_leg, 0),
                            torch.where(out_cpu.aero.alive, out_cpu.aero.hyst_leg, 0)))
    print(f"[card-vs-cpu-chem] 12x12x4, 16/cell, 77 gases, DMS 0.2 ppb, chem_dt 60: "
          f"gases max rel {g_rel:.2e}; {line}; hysteresis legs equal {legs}")
    require(legs, "card vs CPU, chem on: hysteresis legs differ")


def _domain_means(model, state) -> dict:
    """Domain means of three gases [ppb] and of aerosol nitrate [ug m-3]."""
    import torch

    from wrf_partmc_tpu_torch.models.coupled.driver import cell_volume_3d

    gd, ad = model.gas_data, model.aero_data
    out = {g: float(state.gas[..., gd.spec_by_name(g)].mean()) for g in ("O3", "NO2", "HNO3")}
    s = ad.spec_by_name("NO3")
    mass = torch.sum(state.aero.vol[..., s, :] * state.aero.num, -1) * ad.density[s]
    out["NO3_aer_ugm3"] = float((mass / cell_volume_3d(state.dyn, model.grid)).mean() * 1e9)
    return out


def phase_chem_main_path(kernels: dict, n_timed: int = 30):
    import torch

    from wrf_partmc_tpu_torch.entry import build
    from wrf_partmc_tpu_torch.utils.tree import tensor_leaves

    t0 = time.perf_counter()
    model, state = build(40, 40, 10, n_part=100, cap=128, chem_on=True, chem_dt=300.0,
                         device="cuda")
    torch.cuda.synchronize()
    m_chem = round(model.cfg.partmc.partmc_chem_dt / model.cfg.dynamics.dt)
    require(m_chem == n_timed, f"chem cadence {m_chem} != {n_timed} timed steps")
    print(f"[chem-main] build 40x40x10, 100/cell, cap 128, 77 gases, chem_dt 300 s: "
          f"{time.perf_counter() - t0:.3f} s, alive {int(state.aero.n_alive().sum())}, "
          f"means {json.dumps(_domain_means(model, state))}")
    # step 0 runs the chemistry macro-step, then steps 1..30, of which
    # step 30 runs it again
    box, state, draws = [state], None, {}   # drive holds the only reference
    restore_draws = record_draws(draws)
    state, warm, dt, launches, shapes = drive(model, box, n_timed)
    restore_draws()
    cells = 40 * 40 * 10
    ms = 1e3 * dt / n_timed
    DRAWS["chem-on main path"] = (draws, n_timed + 1, ms)
    alive = int(state.aero.n_alive().sum())
    means = _domain_means(model, state)
    print(f"[chem-main] warm-up step (chemistry) {1e3 * warm:.3f} ms; {n_timed} timed "
          f"steps {1e3 * dt:.3f} ms = {ms:.3f} ms/step, {cells * n_timed / dt:.1f} "
          f"cell-steps/s; alive {alive}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}; "
          f"means {json.dumps(means)}")
    for name, leaf in tensor_leaves(state, "state").items():
        if leaf.is_floating_point():
            require(bool(torch.isfinite(leaf).all()), f"chem-on main path: {name} not finite")
    require(tuple(state.gas.shape) == (10, 40, 40, 77), "bad gas shape")
    require(alive > 0, "no particle alive")
    require(all(v == v and v >= 0.0 for v in means.values()), f"bad means {means}")
    require_launched(kernels, "launches_chem_on", launches, "chem-on main path", n_timed + 1)
    state, _ = draw_split("chem-on main path", model, state)
    return model, state, shapes


def phase_chem_split(model, state, reps: int = 3):
    """The chemistry macro-step alone, at the state the chem-on path left."""
    import numpy as np
    import torch

    from wrf_partmc_tpu_torch.models.coupled.driver import make_env, step_time
    from wrf_partmc_tpu_torch.models.partmc import cbmz, mosaic

    cfg, mech, gd, ad = model.cfg, model.mech, model.gas_data, model.aero_data
    pc = cfg.partmc
    env = make_env(state.dyn, model.grid, cfg, state.step)
    cosz = cbmz.solar_cos_zenith(cfg.domain, step_time(state.step, cfg.dynamics.dt))
    cosz = cosz.to("cuda")
    dt_chem = pc.partmc_chem_dt

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def median_ms(fn):
        return statistics.median(timed(fn)[1] for _ in range(reps))

    whole = median_ms(lambda: mosaic.mosaic_timestep(
        mech, state.aero, state.gas, gd, ad, env, dt_chem, cosz,
        n_sub_gas=pc.n_sub_gas, n_sub_astem=pc.n_sub_astem))
    gas_c, t_cbmz = timed(lambda: cbmz.cbmz_step(
        mech, state.gas, env.temp, env.pressure, env.rel_humid, cosz, dt_chem,
        n_sub=pc.n_sub_gas))
    # the same CBM-Z step piece by piece, in the slices cbmz_step uses
    S = state.gas.shape[-1]
    conc0 = state.gas.reshape(-1, S)
    T, P, RH = (x.reshape(-1) for x in (env.temp, env.pressure, env.rel_humid))
    N = conc0.shape[0]
    h = float(np.float32(dt_chem) / np.float32(pc.n_sub_gas))
    parts = dict(rate_coefficients=0.0, jacobian=0.0, fast_inv=0.0, substeps=0.0)
    blocks = []
    block = cbmz.CELL_BLOCK
    for s in range(0, N, block):
        sl = slice(s, min(s + block, N))
        mu = cosz.expand(sl.stop - sl.start)
        k, ms = timed(lambda: cbmz.rate_coefficients(mech, T[sl], P[sl], RH[sl], mu))
        parts["rate_coefficients"] += ms
        A, ms = timed(lambda: cbmz.ros2_operator(mech, conc0[sl], k, h))
        parts["jacobian"] += ms
        a_inv, ms = timed(lambda: cbmz.fast_inv(A))
        parts["fast_inv"] += ms

        def substeps():
            c = conc0[sl]
            for _ in range(pc.n_sub_gas):
                c = cbmz.ros2_substep_w(mech, c, k, h, a_inv)
            return c
        c, ms = timed(substeps)
        parts["substeps"] += ms
        blocks.append(c)
    pieces = torch.cat(blocks).reshape(gas_c.shape)
    require(torch.allclose(pieces, gas_c, rtol=1e-6, atol=0.0),
            "chem split: the pieces do not rebuild cbmz_step")
    (aero_a, gas_a), t_astem = timed(lambda: mosaic.astem_inorganic(
        state.aero, gas_c, gd, ad, env, dt_chem, n_sub=pc.n_sub_astem))
    _, t_soa = timed(lambda: mosaic.soa_partition(aero_a, gas_a, gd, ad, env, dt_chem))
    total = sum(parts.values()) + t_astem + t_soa
    print(f"[chem-split] mosaic_timestep 40x40x10 x 128 slots, 77 gases, median of {reps}: "
          f"{whole:.3f} ms; cbmz_step alone {t_cbmz:.3f} ms; synced pieces "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f", astem_inorganic {t_astem:.3f} ms, soa_partition {t_soa:.3f} ms; "
          f"fast_inv share of the pieces' {total:.3f} ms: {parts['fast_inv'] / total:.3f}")


def phase_40class(kernels: dict):
    import torch

    from wrf_partmc_tpu_torch.entry import build

    t0 = time.perf_counter()
    model, state = build(40, 40, 10, n_part=1000, cap=1280, n_sources=38, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # step 0 (coagulation) and step 1
    box, state = [state], None          # drive holds the only reference
    state, warm, dt, launches, shapes = drive(model, box, 1)
    alive = int(state.aero.n_alive().sum())
    print(f"[40class] 40x40x10, 1000/cell, n_sources=38, n_class {model.cfg.n_class}: "
          f"build {build_s:.3f} s; step 0 (coagulation) {1e3 * warm:.3f} ms, step 1 "
          f"{1e3 * dt:.3f} ms; alive {alive}; launches {launches}")
    require(model.cfg.n_class >= 39, "40-class universe not built")
    require(bool(torch.isfinite(state.aero.num).all()), "40-class: num not finite")
    require(bool(torch.isfinite(state.dyn.num_conc).all()), "40-class: num_conc not finite")
    require(alive > 0, "40-class: no particle alive")
    require_launched(kernels, "launches_40class", launches, "40-class path", 2)
    return shapes


CARES_CELLS = 72 * 72 * 24


def phase_card_vs_cpu_cares(kernels: dict):
    """One CARES-shaped step (MYJ, Morrison, Grell, correlated-k radiation
    with the aerosol optics through K5, Noah, open boundaries, chemistry on)
    at 12x10x8 on the card against the same step on the CPU (the optics'
    plain version): K5 launched once and held at its shape; the dycore and
    particles by ``compare_card_cpu``, gases as phase 6, the Noah skin and
    soil temperatures and the MYJ q2 by the JAX parity rule of
    tests/test_torch_cares_coupled.py (rtol 1e-5), q2 with an absolute
    floor of 1e-6, 5e-5 of its minimum Q2_MIN = 0.02."""
    import torch

    from wrf_partmc_tpu_torch.cares import build_cares_shape

    model, state = build_cares_shape(12, 10, 8, n_part=16, cap=32, chem_on=True,
                                     device="cpu")
    out_cpu = model(state)                      # step 0 runs the chemistry
    reset_counts()
    out_gpu = model.to("cuda")(state.to("cuda")).to("cpu")
    launches, shapes = read_counts()
    require(launches["mie_fit_bulk"] == 1,
            f"card vs CPU, CARES: K5 launched {launches['mie_fit_bulk']} times in one step")
    g_rel = float(((out_gpu.gas - out_cpu.gas).abs() / (out_cpu.gas.abs() + 1e-9)).max())
    require(torch.allclose(out_gpu.gas, out_cpu.gas, rtol=1e-4, atol=1e-9),
            f"card vs CPU, CARES: gases max rel {g_rel}")
    line = compare_card_cpu("card vs CPU, CARES", out_gpu, out_cpu)
    extra = {}
    for name, a, b, atol in (("land.tsk", out_gpu.land.tsk, out_cpu.land.tsk, 0.0),
                             ("land.t_soil", out_gpu.land.t_soil, out_cpu.land.t_soil, 0.0),
                             ("pbl_q2", out_gpu.pbl_q2, out_cpu.pbl_q2, 1e-6)):
        extra[name] = float((a - b).abs().max())
        require(torch.allclose(a, b, rtol=1e-5, atol=atol),
                f"card vs CPU, CARES: {name} max diff {extra[name]}")
    require(float((out_cpu.land.tsk - state.land.tsk).abs().max()) > 1e-3,
            "card vs CPU, CARES: the LSM did not run")
    print(f"[card-vs-cpu-cares] 12x10x8, 16/cell, 77 gases: gases max rel {g_rel:.2e}; "
          + " ".join(f"{k} max diff {v:.2e};" for k, v in extra.items()) + f" {line}; "
          f"K5 launches {launches['mie_fit_bulk']}")
    phase_path_shapes("CARES card-vs-CPU step", kernels,
                      {name: shapes[name] for name in OPTICS_KERNELS})


def phase_cares_path(kernels: dict, n_timed: int = 20):
    """The CARES shape at 72x72x24, 100 particles per cell (capacity 128),
    chem_dt 300 s at dt 30 s: a warm-up step (step 0, chemistry) and
    ``n_timed`` timed steps (two chemistry macro-steps, past step 16 where
    the reference went NaN before its wrfbdy forced mu and ph)."""
    import torch

    from wrf_partmc_tpu_torch.cares import build_cares_shape

    t0 = time.perf_counter()
    model, state = build_cares_shape(72, 72, 24, n_part=100, cap=128, dt=30.0,
                                     chem_on=True, device="cuda")
    torch.cuda.synchronize()
    m_chem = round(model.cfg.partmc.partmc_chem_dt / model.cfg.dynamics.dt)
    require(n_timed % m_chem == 0, f"{n_timed} timed steps hold no whole chem cadence")
    print(f"[cares] build 72x72x24, 100/cell, cap 128, 77 gases, chem_dt 300 s, dt 30 s: "
          f"{time.perf_counter() - t0:.3f} s, alive {int(state.aero.n_alive().sum())}")
    by_caller, captured, draws = {}, {}, {}
    restore = attribute_launches(by_caller, captured, optics=True)
    restore_draws = record_draws(draws)
    box, state = [state], None          # drive holds the only reference
    state, warm, dt, launches, shapes = drive(model, box, n_timed)
    restore_draws()
    restore()
    ms = 1e3 * dt / n_timed
    DRAWS["CARES path"] = (draws, n_timed + 1, ms)
    PATH_MS["CARES path"] = ms
    alive = int(state.aero.n_alive().sum())
    means = _domain_means(model, state)
    mu_max = float(state.dyn.mu.abs().max())
    print(f"[cares] warm-up step (chemistry) {1e3 * warm:.3f} ms; {n_timed} timed steps "
          f"{1e3 * dt:.3f} ms = {ms:.3f} ms/step, {CARES_CELLS * n_timed / dt:.1f} "
          f"cell-steps/s; alive {alive}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}; "
          f"max |mu'| {mu_max:.3f} Pa; means {json.dumps(means)}")
    for name, x in (("theta_p", state.dyn.theta_p), ("mu", state.dyn.mu),
                    ("moist", state.dyn.moist), ("gas", state.gas),
                    ("aero.num", state.aero.num), ("land.tsk", state.land.tsk),
                    ("pbl_q2", state.pbl_q2)):
        require(bool(torch.isfinite(x).all()), f"CARES path: {name} not finite")
    require(mu_max < 3000.0, f"CARES path: surface-pressure perturbation {mu_max} Pa")
    require(state.step == n_timed + 1, "CARES path: step count")
    require(alive > 0, "CARES path: no particle alive")
    require(all(v == v and v >= 0.0 for v in means.values()), f"bad means {means}")
    require_launched(kernels, "launches_cares", launches, "CARES path", n_timed + 1,
                     optics=True)
    for name in OPTICS_KERNELS:       # the main path of the optics kernels
        kernels[name]["launches"] = launches[name]
    require(launches["mie_fit_bulk"] == n_timed + 1,
            f"CARES path: K5 launched {launches['mie_fit_bulk']} times in {n_timed + 1} steps")
    print(f"[cares] kernel launches by caller: {json.dumps(by_caller)}")
    for caller, n in by_caller.items():
        require(n > 0, f"CARES path: no kernel launch from {caller}")
    state, _ = draw_split("CARES path", model, state)
    state = optics_split("CARES path", model, state)
    state, _, _, split = synced_split(model, state, m_chem, "cares", extra=cares_split_sites())
    OPTICS_SPLITS["CARES synced split"] = split
    return shapes, captured


OPTICS_SPLITS = {}           # per path: the synced optics, K5 and plain; the CARES split


def cares_split_sites():
    """The CARES step's sections beyond ``split_sites``: the lateral
    boundaries, MYJ, Morrison, the optics (its K5 sums inside), the
    photolysis factor, Grell, Noah, the inflow resampling and the gas BCs."""
    from wrf_partmc_tpu_torch.models.coupled import driver
    from wrf_partmc_tpu_torch.models.dycore import arw
    from wrf_partmc_tpu_torch.models.partmc import optics

    d = driver
    return ((d, "apply_specified_relax", "lateral BCs"),
            (d, "myj_surface_layer", "MYJ surface layer"), (d, "myj_tke_step", "MYJ"),
            (arw, "morrison_step", "dycore/Morrison"), (d, "bulk_optical_props", "optics"),
            (optics, "mie_fit_sums", "optics/K5 sums"),
            (d, "photolysis_aerosol_factor", "photolysis factor"), (d, "grell_step", "Grell"),
            (d, "noah_lsm_step", "Noah"), (d, "resample_inflow_particles", "inflow"),
            (d, "apply_gas_open_bc", "gas BCs"))


def optics_split(path: str, model, state, steps: int = 2):
    """``steps`` steps with the aerosol optics (``bulk_optical_props``) and
    inside it the fitted sums (``optics.mie_fit_sums``) each between two
    synchronizes, the sums through K5, then ``steps`` with the sums through
    the plain version (as they ran before K5): each run's step ms, optics
    ms, sums ms and the optics' share of the step, and the optics' peak
    memory above what was allocated when the optics began (the optics'
    own temporaries; the step's peak lies elsewhere).  The first K5 call is
    also held against the plain version on the path's own population (its
    diameters, indices and numbers).  Returns the state."""
    import torch

    from wrf_partmc_tpu_torch.models.coupled import driver
    from wrf_partmc_tpu_torch.models.partmc import optics

    res, population = {}, []
    for how in ("K5", "plain"):
        acc = {"optics": 0.0, "sums": 0.0, "peak": 0.0}

        def timed(label, fn, args, kwargs, _how=how, _acc=acc):
            if label == "sums" and _how == "plain":
                fn = optics.mie_fit_sums_plain
            elif label == "sums" and not population:
                population.extend(a.clone() for a in args[:4])
            torch.cuda.synchronize()
            if label == "optics":
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            _acc[label] += 1e3 * (time.perf_counter() - t0)
            if label == "optics":
                _acc["peak"] = max(_acc["peak"], (torch.cuda.max_memory_allocated() - base) / 2**30)
            return out
        restore = patch_sites([(driver, "bulk_optical_props", "optics"),
                               (optics, "mie_fit_sums", "sums")], timed)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state = model(state)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / steps
        finally:
            restore()
        res[how] = dict(step_ms=step_ms, optics_ms=acc["optics"] / steps,
                        sums_ms=acc["sums"] / steps, share=acc["optics"] / steps / step_ms,
                        peak_gib=acc["peak"])
    res["held"] = k5_hold(f"K5 on the {path}'s population", optics.mie_fit_sums(*population),
                          optics.mie_fit_sums_plain(*population))
    res["held_shape"] = list(population[0].shape)
    del population
    OPTICS_SPLITS[path] = res
    print(f"[optics] {path}, {steps} steps each with synced optics: " + "; ".join(
        f"{how} optics {r['optics_ms']:.3f} (sums {r['sums_ms']:.3f}) of {r['step_ms']:.3f} "
        f"ms/step ({100 * r['share']:.2f}%), the optics' peak {r['peak_gib']:.3f} GiB above "
        "its start"
        for how in ("K5", "plain") for r in [res[how]])
        + f"; K5 on the path's {res['held_shape']} population: sums within "
        f"{K5_TOL['rtol']:g} of the cell's extinction (max abs err {res['held']:.3e})")
    return state


def patch_sites(sites, hook):
    """Replace each (module, attribute) of ``sites`` by a wrapper that calls
    ``hook(label, fn, args, kwargs)``.  Returns a function that restores
    the modules."""
    saved = []
    for mod, attr, label in sites:
        inner = getattr(mod, attr)

        def wrapped(*args, _inner=inner, _label=label, **kwargs):
            return hook(_label, _inner, args, kwargs)
        saved.append((mod, attr, inner))
        setattr(mod, attr, wrapped)

    def restore():
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)
    return restore


def attribute_launches(by_caller: dict, captured: dict, rebalance: bool = False,
                       optics: bool = False):
    """Count, per caller, the kernel launches made inside the calls each of
    these modules makes to the kernels' dispatchers: K1 from the MYJ q2
    column and the Noah soil column, K2 and K3 from the transport rebucket,
    K3 from the coagulation pairing, and with ``rebalance`` K3 inside the
    driver's particle rebalance and, within it, ``split_largest``.  The
    first call of K2 or K3 at each (caller, shape) from a dispatcher also
    leaves a copy of its index array in ``captured`` (the path's own dst
    and src; keyed (kernel, caller, payload shape, slots)).  With
    ``optics``, K5 in the driver's aerosol optics.  Returns a function that
    restores the modules."""
    from wrf_partmc_tpu_torch.models.coupled import driver, transport
    from wrf_partmc_tpu_torch.models.partmc import aero_state, coag
    from wrf_partmc_tpu_torch.models.physics import lsm, myj

    fns = _kernel_fns()
    kernel_of = {"K1 in MYJ": "thomas_solve", "K1 in Noah": "thomas_solve",
                 "K2 in the rebucket": "scatter_rows", "K3 in the rebucket": "gather_rows",
                 "K3 in coagulation": "gather_rows"}
    sites = [(myj, "tridiag_solve", "K1 in MYJ"), (lsm, "tridiag_solve", "K1 in Noah"),
             (transport, "scatter_rows", "K2 in the rebucket"),
             (transport, "gather_rows", "K3 in the rebucket"),
             (coag, "gather_rows", "K3 in coagulation")]
    wrappers = set()                 # callers that are not a kernel's dispatcher
    if rebalance:
        wrappers = {"K3 in rebalance", "K3 in rebalance/split_largest"}
        kernel_of.update({k: "gather_rows" for k in wrappers})
        sites += [(driver, "rebalance", "K3 in rebalance"),
                  (aero_state, "split_largest", "K3 in rebalance/split_largest")]
    if optics:
        kernel_of["K5 in the optics"] = "mie_fit_bulk"
        sites.append((driver, "bulk_optical_props", "K5 in the optics"))
    by_caller.update({caller: 0 for caller in kernel_of})

    def hook(caller, fn, args, kwargs):
        kernel = kernel_of[caller]
        if kernel in ("scatter_rows", "gather_rows") and caller not in wrappers:
            x, idx = args[0], args[1]
            slots = args[2] if kernel == "scatter_rows" else idx.shape[1]
            key = (kernel, caller, tuple(x.shape), slots)
            if key not in captured:
                captured[key] = idx.clone()
        before = fns[kernel].launches
        out = fn(*args, **kwargs)
        by_caller[caller] += fns[kernel].launches - before
        return out
    return patch_sites(sites, hook)


# per path: ({K4 argument key: calls}, steps, ms/step) of the bulk draws
# (rng.random_bits, uniform, normal) on the card in its run
DRAWS = {}
DRAW_SPLITS = {}             # per path: the synced draws, K4 and plain
PATH_LAUNCHES = {}           # per path: (kernel launches, steps)
PATH_MS = {}                 # ms/step of the paths later phases compare with
DRAW_FNS = ("random_bits", "uniform", "normal")


def draw_args(name: str, fn, args, kwargs):
    """(K4's argument key (mode, shape, lo, span, block arguments) as the
    kernel's wrapper records it, the key, the ``rng.Block``, the device) of
    the rng draw ``name`` called with ``args``/``kwargs``; None for a draw
    on another device than a card."""
    import inspect

    import torch

    from wrf_partmc_tpu_torch.utils import rng

    a = inspect.signature(fn).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    if torch.device(a["device"]).type != "cuda":
        return None
    shape, block = tuple(int(v) for v in a["shape"]), a["block"]
    lo, span = {"random_bits": (0.0, 1.0), "normal": (rng.NORMAL_LO, rng.NORMAL_SPAN)}.get(
        name) or rng._lo_span(a["minval"], a["maxval"])
    mode = "bits" if name == "random_bits" else name
    return ((mode, shape, float(lo), float(span),
             None if block is None else tuple(block.kernel_args(shape))), a["k"], block,
            a["device"])


def record_draws(draws: dict, timing: dict | None = None, plain: bool = False):
    """Count the bulk draws on the card (``rng.random_bits``, ``uniform``,
    ``normal``; randint, gumbel and categorical draw through them) by K4's
    argument key in ``draws``.  With ``timing``, each runs between two
    ``torch.cuda.synchronize()`` and its host time is added to
    ``timing["ms"]``; with ``plain``, the plain version (``rng.draw_plain``)
    runs in place of K4.  Returns a function that restores the module."""
    import torch

    from wrf_partmc_tpu_torch.utils import rng

    def hook(name, fn, args, kwargs):
        found = draw_args(name, fn, args, kwargs)
        if found is None:
            return fn(*args, **kwargs)
        key, k, block, device = found
        draws[key] = draws.get(key, 0) + 1
        mode, shape, lo, span, _ = key
        call = ((lambda: rng.draw_plain(mode, k, shape, device, lo, span, block)) if plain
                else (lambda: fn(*args, **kwargs)))
        if timing is None:
            return call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        timing["ms"] += 1e3 * (time.perf_counter() - t0)
        return out
    return patch_sites([(rng, name, name) for name in DRAW_FNS], hook)


def draw_split(path: str, model, state, steps: int = 2, echo: bool = True):
    """``steps`` steps with every bulk draw synchronized on both sides
    through K4, then ``steps`` through the plain version called explicitly
    (the draws as they ran before K4): each run's step ms, draw ms and the
    draws' share of the step; with ``echo`` printed and kept for phase 31.
    Returns (state, the two records)."""
    import torch

    res = {}
    for how in ("K4", "plain"):
        timing, draws = {"ms": 0.0}, {}
        restore = record_draws(draws, timing, plain=how == "plain")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state = model(state)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / steps
        finally:
            restore()
        res[how] = dict(step_ms=step_ms, draw_ms=timing["ms"] / steps,
                        share=timing["ms"] / steps / step_ms,
                        draws=sum(draws.values()) / steps)
    if echo:
        DRAW_SPLITS[path] = res
        print(f"[draws] {path}, {steps} steps each with synced draws: {split_text(res)}")
    return state, res


def split_text(res: dict) -> str:
    return "; ".join(f"{how} {r['draw_ms']:.3f} of {r['step_ms']:.3f} ms/step "
                     f"({100 * r['share']:.2f}%, {r['draws']:g} draws a step)"
                     for how, r in res.items())


def phase_normal_cost():
    """What the float32 erfinv of XLA-CPU (``rng.erfinv_xla``, which keeps
    ``rng.normal`` bit-equal to ``jax.random.normal`` on the CPU) costs
    each path against ``torch.erfinv``: at each flat normal draw shape a
    path made, the call time of ``rng.normal`` (K4, the erfinv inside the
    kernel) and of K4's uniform through ``torch.erfinv``, and the
    difference times the draws a step.  At each shape the card's draw must
    equal the CPU's bit for bit."""
    import math

    import torch

    from wrf_partmc_tpu_torch.utils import rng

    k = rng.key(0)
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    sqrt2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
    timed = {}
    for path, (draws, steps, step_ms) in DRAWS.items():
        normals = {}
        for (mode, shape, _, _, blk), calls in draws.items():
            if mode == "normal" and blk is None:
                normals[shape] = normals.get(shape, 0) + calls
        extra, parts = 0.0, []
        for shape, calls in sorted(normals.items()):
            if shape not in timed:
                ours = call_ms(lambda: rng.normal(k, shape, "cuda"), 20)
                torchs = call_ms(lambda: sqrt2 * torch.erfinv(
                    rng.uniform(k, shape, "cuda", lo, 1.0)), 20)
                a = rng.normal(k, shape, "cuda")
                b = sqrt2 * torch.erfinv(rng.uniform(k, shape, "cuda", lo, 1.0))
                require(torch.equal(a.cpu(), rng.normal(k, shape, "cpu")),
                        f"rng.normal {list(shape)}: the card's draw differs from the CPU's")
                timed[shape] = (ours, torchs, float((a - b).abs().max()),
                                float((a == b).float().mean()))
            ours, torchs, diff, same = timed[shape]
            extra += calls * (ours - torchs) / steps
            parts.append(f"{list(shape)} x{calls}: bit-equal to the CPU's, {ours:.3f} ms "
                         f"against torch.erfinv "
                         f"{torchs:.3f} ms (max |diff| {diff:.2e}, bit-equal {same:.4f})")
        print(f"[normal-cost] {path}, {steps} steps: " + ("; ".join(parts) or "no draws")
              + f"; erfinv_xla costs {extra:.3f} ms/step more, {100 * extra / step_ms:.3f}% "
              f"of its {step_ms:.3f} ms/step")


def phase_path_indices(label: str, captured: dict):
    """K2 and K3 on the index arrays a path gave them in its first transport
    and coagulation steps (random payloads of the same shapes; the time of
    a copy does not depend on the values): bit-exactness, the kernel's,
    plain and library times, the bound for these indices and the share of
    rows that move."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    for (kernel, caller, x_shape, slots), idx in sorted(captured.items()):
        x = torch.randn(x_shape, generator=gen, device="cuda")
        tag = f"{label}, {caller}, path indices, {list(x_shape)}->{slots}"
        if kernel == "scatter_rows":
            time_scatter(x, idx, slots, tag)
        else:
            time_gather(x, idx, tag)
        del x
        torch.cuda.empty_cache()


DIAG_FIELDS = ("num_dist", "mass_dist", "spec_mass", "num_conc", "chi", "d_alpha",
               "d_gamma", "chi_sub", "ccn", "pm1", "pm25", "pm10", "b_scat", "b_abs",
               "b_scat_mix", "b_abs_mix", "ccn_mix")


def phase_diag_card_vs_cpu():
    """The gridded diagnostics (``diagnostics.process``, advanced on) on the
    card against the CPU, on the 12x12x4 em_uniform state with its particles
    made of five species and one cell emptied: every field to rtol 1e-4 with a floor of 1e-6 of its largest
    value (last-ulp transcendentals, and float atomics in the card's binning
    sums), NaN exactly where the CPU has NaN (the empty cell's D_alpha), chi
    in [0, 1]."""
    import dataclasses

    import torch

    from wrf_partmc_tpu_torch.entry import build
    from wrf_partmc_tpu_torch.models.coupled.driver import make_env
    from wrf_partmc_tpu_torch.models.partmc.bin_grid import make_bin_grid
    from wrf_partmc_tpu_torch.models.partmc.diagnostics import process
    from wrf_partmc_tpu_torch.utils.tree import tree_map

    model, state = build(12, 12, 4, n_part=16, cap=48, device="cpu")
    a, ad = state.aero, model.aero_data
    # the SO4 particles' volume spread over five species from a seed, SO4
    # at least half (solute kappa >= 0.3, where the critical
    # supersaturations are well conditioned), so chi spans (0, 1)
    gen = torch.Generator().manual_seed(3)
    names = ("SO4", "NO3", "NH4", "OC", "BC")
    w = torch.rand((len(names), *a.num.shape), generator=gen)
    w[0] += w.sum(0)
    w = w / w.sum(0)
    vol = a.vol.clone()
    total = a.vol.sum(-2)
    for i, name in enumerate(names):
        vol[..., ad.spec_by_name(name), :] = total * w[i]
    empty = torch.zeros(a.num.shape[:-1], dtype=torch.bool)
    empty[1, 5, 7] = True
    aero = dataclasses.replace(a, num=torch.where(empty[..., None], 0.0, a.num),
                               vol=torch.where(empty[..., None, None], 0.0, vol))
    env = make_env(state.dyn, model.grid, model.cfg, state.step)
    out = {}
    for dev in ("cpu", "cuda"):
        pc = model.cfg.partmc
        bg = make_bin_grid(pc.num_bins, pc.bin_d_min, pc.bin_d_max, device=dev)
        on = lambda x: tree_map(lambda t: t.to(dev), x)
        out[dev] = tree_map(lambda t: t.cpu(), process(
            on(aero), on(model.aero_data), on(env), bg, advanced=True))
    worst = {}
    for name in DIAG_FIELDS:
        g, c = getattr(out["cuda"], name), getattr(out["cpu"], name)
        require(torch.equal(torch.isnan(g), torch.isnan(c)), f"diagnostics: {name} NaN differ")
        fin = ~torch.isnan(c)
        atol = 1e-6 * float(c[fin].abs().max()) if bool(fin.any()) else 0.0
        worst[name] = float(((g - c)[fin].abs() / (c[fin].abs() + atol + 1e-300)).max())
        require(torch.allclose(g[fin], c[fin], rtol=1e-4, atol=atol),
                f"diagnostics card vs CPU: {name} max rel {worst[name]}")
    chi = out["cuda"].chi
    require(bool(((chi >= 0) & (chi <= 1)).all()), "diagnostics: chi outside [0, 1]")
    require(bool(torch.isnan(out["cuda"].d_alpha[1, 5, 7])) and float(chi[1, 5, 7]) == 1.0,
            "diagnostics: the empty cell is not NaN D_alpha, chi 1")
    require(float(chi.min()) < 0.99, "diagnostics: the mixed population gives chi 1")
    print("[diag-card-vs-cpu] 12x12x4, 16/cell, 5 species, one empty cell, 100 bins, "
          "advanced: max rel "
          + " ".join(f"{k}={v:.1e}" for k, v in worst.items())
          + f"; chi range [{float(chi.min()):.4f}, {float(chi.max()):.4f}]")


def _runner_cfg(steps: int):
    """The runner's intervals the namelist shim does not map: auxhist2 and
    restart every 6 steps (60 s at dt 10 s)."""
    import dataclasses

    def configure(cfg):
        return cfg.replace(time_control=dataclasses.replace(
            cfg.time_control, run_seconds=steps * cfg.dynamics.dt,
            auxhist2_interval_s=60.0, restart_interval_s=60.0))
    return configure


def phase_cases():
    """Each ideal case of ``run.CASES`` through ``run.build_model`` on the
    card, 20x20x10, 100 per cell (capacity 128), live dynamics, emission,
    coagulation, deposition and transport on, for 2 steps.  20 cells wide:
    em_rotational's default period (100 dt) spins the domain's corners past
    CFL 1 at dx 2 km, dt 10 s from about 32 cells wide, and both packages'
    dycores then go NaN."""
    import dataclasses

    import torch

    from wrf_partmc_tpu_torch import run
    from wrf_partmc_tpu_torch.config import DomainConfig, PartmcConfig, uniform_test_config

    cfg = uniform_test_config().replace(
        domain=DomainConfig(nx=20, ny=20, nz=10),
        partmc=PartmcConfig(num_particles=100, max_particles=128, n_emit_slots=4))
    cfg = cfg.replace(dynamics=dataclasses.replace(cfg.dynamics, constant_velocity=False))
    reset_counts()
    line = []
    for case in sorted(run.CASES):
        model, state = run.build_model(cfg, case, device="cuda")
        alive0 = int(state.aero.n_alive().sum())
        t0 = time.perf_counter()
        for _ in range(2):
            state = model(state)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 2
        alive = int(state.aero.n_alive().sum())
        for name in ("u", "w", "theta_p", "p_p"):
            require(bool(torch.isfinite(getattr(state.dyn, name)).all()),
                    f"case {case}: {name} not finite")
        require(bool(torch.isfinite(state.aero.num).all()), f"case {case}: num not finite")
        require(state.step == 2 and alive > 0, f"case {case}: step {state.step}, alive {alive}")
        line.append(f"{case} alive {alive0}->{alive}, {ms:.3f} ms/step, max|w| "
                    f"{float(state.dyn.w.abs().max()):.3e}")
        del model, state
    launches, shapes = read_counts()
    print("[cases] 20x20x10, 100/cell, 2 steps each on cuda: " + "; ".join(line)
          + f"; launches {launches}")
    return shapes


RUNNER_DIR = os.path.join(ROOT, "build", "runner")
CELL = (10, 40, 40)
HIST_VARS = dict(
    {k: CELL for k in ("U", "V", "T", "P", "QVAPOR", "chi", "d_alpha", "d_gamma",
                       "chi_sub", "pm1", "pm25", "pm10", "b_scat", "b_abs", "b_scat_mix",
                       "b_abs_mix")},
    W=(11, 40, 40), NUM_CONC=(4, *CELL), ZH=(10,), num_dist=(*CELL, 100),
    mass_dist=(*CELL, 100), spec_mass=(*CELL, 20), ccn=(*CELL, 4), ccn_mix=(*CELL, 4),
    **{f"removed_num_{c}": CELL for c in ("dilution", "coag", "chem", "outflow",
                                          "deposition", "halving")},
    **{f"trans_{c}": () for c in ("movers", "overflow_class", "overflow_free")})
PART_VARS = dict(
    aero_particle_vol=(*CELL, 20, 1280), aero_comp_source=(*CELL, 3, 1280),
    aero_comp_vol=(*CELL, 3, 1280), next_id=CELL, gas_mixrat=(*CELL, 32),
    **{k: (*CELL, 1280) for k in ("aero_num", "aero_id", "aero_source",
                                  "aero_weight_class", "aero_create_time",
                                  "aero_water_hyst_leg")})


def _check_schema(path: str, want: dict) -> dict:
    """The file holds exactly the JAX writer's variables with their shapes;
    returns its small variables' values."""
    import numpy as np
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=True)
    got = {k: tuple(v.shape) for k, v in f.variables.items()}
    small = {k: np.array(v[:]) if v.shape else float(v.getValue())
             for k, v in f.variables.items() if np.prod(v.shape) < 2_000_000}
    f.close()
    require(got == want, f"{os.path.basename(path)}: variables {sorted(set(got) ^ set(want))} "
            f"or shapes differ from the JAX writer's")
    return small


def _sizes(paths) -> str:
    return ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 2**20:.1f} MiB"
                     for p in paths)


def phase_runner(kernels: dict, steps: int = 12):
    """``run.main`` at the em_uniform namelist width: 40x40x10 at 2 km, dt
    10 s, 1000 particles per cell (capacity 1280), live dynamics with
    emission, coagulation (chem_dt 60 s), deposition and transport,
    removals and coagulation records on; history and auxhist2 every 6
    steps, the npz restart at step 6, 12 steps.  Then the same
    model stepped bare, and each file writer timed alone on the final
    state."""
    import shutil

    import numpy as np

    import torch

    from wrf_partmc_tpu_torch import run
    from wrf_partmc_tpu_torch.models.coupled.driver import make_env
    from wrf_partmc_tpu_torch.models.partmc.bin_grid import make_bin_grid
    from wrf_partmc_tpu_torch.models.partmc.diagnostics import process
    from wrf_partmc_tpu_torch.tools.sample_inputs import RUNNER_NAMELIST
    from wrf_partmc_tpu_torch.utils import io

    shutil.rmtree(RUNNER_DIR, ignore_errors=True)
    os.makedirs(RUNNER_DIR)
    nml = os.path.join(RUNNER_DIR, "namelist.input")
    with open(nml, "w") as fh:
        fh.write(RUNNER_NAMELIST)
    out = os.path.join(RUNNER_DIR, "full")
    argv = ["--namelist", nml, "--steps", str(steps), "--outdir", out]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cs, timers = run.main(argv, configure=_runner_cfg(steps))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[runner] {shutil.disk_usage(RUNNER_DIR).free / 2**30:.1f} GiB free under build/")
    files = sorted(os.listdir(out))
    print(f"[runner] 40x40x10, 1000/cell, cap 1280, {steps} steps through run.main: wall "
          f"{wall:.3f} s, peak {peak:.3f} GiB, files: " + _sizes(os.path.join(out, f)
                                                              for f in files))
    for name in ("coupled_step", "partmc_process", "history_write", "restart_write"):
        n, tot = timers.counts[name], timers.totals[name]
        require(n > 0, f"runner: no {name} section")
        print(f"[runner] timer {name}: {n} calls, {tot:.3f} s, {1e3 * tot / n:.3f} ms/call")
    runner_ms = 1e3 * timers.totals["coupled_step"] / timers.counts["coupled_step"]
    for stem in ("wrfout_000000.nc", "wrfout_000006.nc", "partmc_000000.nc",
                 "partmc_000006.nc", "restart_000006.npz", "restart_final.npz"):
        require(stem in files, f"runner: {stem} not written")
    for stem in ("wrfout_000000.nc", "wrfout_000006.nc"):
        h = _check_schema(os.path.join(out, stem), HIST_VARS)
        fin = np.isfinite(h["chi"])
        require(fin.any() and ((h["chi"][fin] >= 0) & (h["chi"][fin] <= 1)).all(),
                f"{stem}: chi outside [0, 1] where finite")
        for k, v in h.items():
            if k.startswith(("removed_num_", "trans_")):
                require(bool(np.isfinite(v).all()), f"{stem}: {k} not finite")
    print(f"[runner] wrfout_000006: chi in [{np.nanmin(h['chi']):.4f}, "
          f"{np.nanmax(h['chi']):.4f}] over {int(fin.sum())} finite cells; removed "
          + " ".join(f"{k[12:]}={float(np.sum(v)):.4e}" for k, v in sorted(h.items())
                     if k.startswith("removed_num_"))
          + "; " + " ".join(f"{k}={h[k]:.0f}" for k in sorted(h) if k.startswith("trans_")))
    _check_schema(os.path.join(out, "partmc_000006.nc"), PART_VARS)
    n_events = sum(_removed_rows(os.path.join(out, f)) for f in files
                   if f.startswith("aero_removed_"))
    require(n_events > 0, "runner: no aero_removed row")
    print(f"[runner] aero_removed rows: {n_events}")
    require_launched(kernels, "launches_runner", launches, "runner path", steps)

    # the same model stepped bare: build, 12 steps, one synchronize
    cfg = _runner_cfg(steps)(run.namelist_to_config(run.load_namelist(nml)))
    model, state = run.build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = model(state)
    torch.cuda.synchronize()
    bare_ms = 1e3 * (time.perf_counter() - t0) / steps
    print(f"[runner] coupled_step in the runner {runner_ms:.3f} ms/step (with the per-step "
          f"counter copy) vs CoupledModel bare {bare_ms:.3f} ms/step: runner/bare "
          f"{runner_ms / bare_ms:.3f}")
    grid, ad = model.grid, model.aero_data
    del state

    # each writer alone, synchronous, on the final state
    wdir = os.path.join(RUNNER_DIR, "writes")
    os.makedirs(wdir)
    pc = cfg.partmc
    t0 = time.perf_counter()
    diag = process(cs.aero, ad, make_env(cs.dyn, grid, cfg, cs.step),
                   make_bin_grid(pc.num_bins, pc.bin_d_min, pc.bin_d_max, device="cuda"))
    torch.cuda.synchronize()
    proc_ms = 1e3 * (time.perf_counter() - t0)
    writes = (("history", "h.nc", lambda p: io.write_history(p, cs, grid, cfg, diag)),
              ("particle", "p.nc", lambda p: io.write_particle_netcdf(p, cs, ad, grid)),
              ("restart npz", "r.npz", lambda p: io.write_restart(p, cs)),
              ("restart NetCDF", "r.nc", lambda p: io.write_restart_netcdf(p, cs, ad, grid)))
    line = [f"process {proc_ms:.3f} ms"]
    for label, stem, fn in writes:
        p = os.path.join(wdir, stem)
        t0 = time.perf_counter()
        fn(p)
        dt = time.perf_counter() - t0
        size = os.path.getsize(p) + (os.path.getsize(p + ".dyn") if stem == "r.nc" else 0)
        line.append(f"{label} {dt:.3f} s {size / 2**20:.1f} MiB")
    print("[runner] writers alone, synchronous, final state: " + "; ".join(line))
    shutil.rmtree(wdir)
    del model, diag
    for f in files:
        if f.startswith("partmc_"):
            os.remove(os.path.join(out, f))
    return cs, shapes, argv


def _removed_rows(path: str) -> int:
    """An aero_removed file with the JAX writer's variables; its row count."""
    import numpy as np
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    names = sorted(f.variables)
    n = int(f._attributes["n_events"])
    rid = np.array(f.variables["aero_removed_removed_id"][:])
    f.close()
    require(names == sorted(f"aero_removed_{c}" for c in ("cell", "other_id",
                                                          "removed_id", "step")),
            f"{os.path.basename(path)}: variables {names}")
    require(int((rid >= 0).sum()) == n, f"{os.path.basename(path)}: {n} events")
    return n


def phase_resume(cs_full, argv, steps: int = 12):
    """Resume from the step-6 npz restart, and from a NetCDF restart of the
    state read back from it, for 6 steps each; each final state must equal
    the continuous run's bit for bit."""
    import shutil

    import torch

    from wrf_partmc_tpu_torch import run
    from wrf_partmc_tpu_torch.utils import io
    from wrf_partmc_tpu_torch.utils.tree import tensor_leaves

    full = tensor_leaves(cs_full, "s")
    cfg = _runner_cfg(steps)(run.namelist_to_config(run.load_namelist(argv[argv.index("--namelist") + 1])))
    model, template = run.build_model(cfg, device="cuda")
    rst = os.path.join(RUNNER_DIR, "full", "restart_000006")
    io.write_restart_netcdf(rst + ".nc", io.read_restart(rst + ".npz", template),
                            model.aero_data, model.grid)
    del model, template
    for stem in ("restart_000006.npz", "restart_000006.nc"):
        out = os.path.join(RUNNER_DIR, f"resume_{stem}")
        a = list(argv)
        a[a.index("--outdir") + 1] = out
        t0 = time.perf_counter()
        cs, _ = run.main(a + ["--restart", os.path.join(RUNNER_DIR, "full", stem)],
                         configure=_runner_cfg(steps))
        torch.cuda.synchronize()
        res = tensor_leaves(cs, "s")
        require(cs.step == cs_full.step == steps, f"resume {stem}: step {cs.step}")
        require(sorted(res) == sorted(full), f"resume {stem}: state fields differ")
        diff = [k for k in full if not torch.equal(full[k], res[k])]
        require(not diff, f"resume {stem}: not bit-equal to the continuous run: {diff[:5]}")
        print(f"[resume] from {stem}: {len(full)} state tensors bit-equal to the continuous "
              f"run after step {steps}; {time.perf_counter() - t0:.3f} s")
        shutil.rmtree(out)
    shutil.rmtree(RUNNER_DIR)


def phase_card_vs_cpu_options():
    """One step of each option set on the card against the same step on the
    CPU, by ``compare_card_cpu``: the mesoscale set (YSU, slab LSM, Dudhia
    and gray radiation, WSM5, BMJ, sea salt) at 12x12x4 with the slab
    LSM's temperatures to rtol 1e-5 (the JAX parity rule of
    tests/test_torch_options_coupled.py), the LES set (TKE, NBA, WENO5/3,
    Kessler) at 12x12x8 with its TKE among the dycore fields and a floor of
    5e-4 of each field's scale, as tests/test_torch_options_coupled.py holds
    it against the JAX package: the weak bubble leaves the reference's own
    jit-against-eager spread of one dycore step at 3.8e-4 of the scale of
    p'."""
    import torch

    from wrf_partmc_tpu_torch.option_sets import OPTION_SETS, build_option_set, lift_tails

    for name, spec in OPTION_SETS.items():
        small = spec.small
        model, state = build_option_set(name, *small, n_part=16, cap=32, device="cpu")
        if spec.lift_tails:
            state = lift_tails(state)
        out_cpu = model(state)
        out_gpu = model.to("cuda")(state.to("cuda")).to("cpu")
        tag = f"card vs CPU, {name} options"
        line = compare_card_cpu(tag, out_gpu, out_cpu, floor=5e-4 if name == "les" else 1e-4)
        extra = ""
        if name == "mesoscale":
            for f in ("tsk", "t_deep"):
                a, b = getattr(out_gpu.land, f), getattr(out_cpu.land, f)
                require(torch.allclose(a, b, rtol=1e-5, atol=0.0),
                        f"{tag}: land.{f} max diff {float((a - b).abs().max())}")
                extra += f"land.{f} max diff {float((a - b).abs().max()):.2e}; "
        print(f"[card-vs-cpu-{name}] {'x'.join(map(str, small))}, 16/cell: {extra}{line}")


def split_sites():
    """The coupled step's sections for a synced split: (module, attribute,
    label); a label with "/" is timed inside the section before it."""
    from wrf_partmc_tpu_torch.models.coupled import driver
    from wrf_partmc_tpu_torch.models.dycore import arw, solve

    d = driver
    return ((d, "partmc_to_wrf", "partmc_to_wrf"), (d, "solve_step", "dycore"),
            (arw, "nba_stress_tendencies", "dycore/NBA stresses"),
            (solve, "tke_advance", "dycore/TKE advance"),
            (arw, "kessler_step", "dycore/Kessler"), (arw, "wsm5_step", "dycore/WSM5"),
            (d, "surface_layer", "YSU surface layer"), (d, "pbl_height", "YSU PBL height"),
            (d, "ysu_exch_h", "YSU exch_h"),
            (d, "vertical_diffusion_state", "vertical diffusion (K1)"),
            (d, "make_env", "env"), (d, "emission_step", "emission"),
            (d, "sample_seasalt", "emission/sea-salt sample"),
            (d, "add_particles", "emission/sea-salt add"),
            (d, "microphysics_step", "coagulation macro-step"), (d, "bmj_step", "BMJ"),
            (d, "radiation_driver", "radiation"), (d, "slab_lsm_step", "slab LSM"),
            (d, "transport_step", "transport"), (d, "surface_deposition", "deposition"),
            (d, "rebalance", "rebalance"))


def synced_split(model, state, steps: int, name: str, extra=()):
    """``steps`` steps with ``torch.cuda.synchronize()`` around every section
    of ``split_sites`` (and the ``extra`` sites): the ms a step of each, the
    synced step, and what the sections saw (the BMJ rain, the sea-salt
    number added per level).  Returns (state, calls, seen, ms by label)."""
    import torch

    acc, calls, seen = {}, {}, {"rain": [], "seasalt": []}

    def hook(label, fn, args, kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
        calls[label] = calls.get(label, 0) + 1
        if label == "BMJ":
            seen["rain"].append(out[1].detach().clone())
        elif label == "emission/sea-salt add":
            num = args[2]                       # [nz, ny, nx, E]
            seen["seasalt"].append(num.sum(dim=(1, 2, 3)).detach().clone())
        return out

    restore = patch_sites(split_sites() + tuple(extra), hook)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state = model(state)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        restore()
    ms = {k: 1e3 * v / steps for k, v in acc.items()}
    top = sum(v for k, v in ms.items() if "/" not in k)
    print(f"[{name}] synced split, {steps} steps: {1e3 * total / steps:.3f} ms/step; "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))
          + f"; the rest {1e3 * total / steps - top:.3f} (ms/step; calls "
          + json.dumps(calls) + ")")
    ms["synced step"] = 1e3 * total / steps
    return state, calls, seen, ms


def phase_options_path(kernels: dict, name: str, n_timed: int = 6, n_split: int = 2):
    """An option set at full width, 1000 particles per cell (capacity 1280):
    a warm-up and ``n_timed`` timed steps with every kernel's launch count,
    then ``n_split`` steps of a synced split.  The mesoscale set must rain
    from BMJ, grow WSM5 ice and snow and add sea salt at level 0 only; the
    LES set must run the TKE advance, the NBA stresses and Kessler."""
    import torch

    from wrf_partmc_tpu_torch.option_sets import OPTION_SETS, build_option_set

    nx, ny, nz = OPTION_SETS[name].full
    t0 = time.perf_counter()
    model, state = build_option_set(name, nx, ny, nz, n_part=1000, cap=1280, device="cuda")
    torch.cuda.synchronize()
    print(f"[{name}] build {nx}x{ny}x{nz}, 1000/cell, cap 1280: "
          f"{time.perf_counter() - t0:.3f} s, alive {int(state.aero.n_alive().sum())}")
    by_caller, draws, ran = {}, {}, {}

    def count_ran(label, fn, args, kwargs):
        ran[label] = ran.get(label, 0) + 1
        return fn(*args, **kwargs)
    restore = attribute_launches(by_caller, {}, rebalance=True)
    restore_draws = record_draws(draws)
    # the dycore's physics, counted while the dycore still runs its Python:
    # the synced split's steps replay the dycore's graph without calling it
    restore_ran = patch_sites([s for s in split_sites() if s[2].startswith("dycore/")],
                              count_ran)
    try:
        box, state = [state], None          # drive holds the only reference
        state, warm, dt, launches, shapes = drive(model, box, n_timed)
    finally:
        restore_ran()
        restore_draws()
        restore()
    DRAWS[f"{name} options path"] = (draws, n_timed + 1, 1e3 * dt / n_timed)
    cells = nx * ny * nz
    alive = int(state.aero.n_alive().sum())
    print(f"[{name}] warm-up step {1e3 * warm:.3f} ms; {n_timed} timed steps "
          f"{1e3 * dt:.3f} ms = {1e3 * dt / n_timed:.3f} ms/step, "
          f"{cells * n_timed / dt:.1f} cell-steps/s; alive {alive}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}; "
          "transport diag " + json.dumps({k: float(v) for k, v in model.last_diag.items()}))
    require_launched(kernels, f"launches_{name}", launches, f"{name} options path",
                     n_timed + 1)
    print(f"[{name}] kernel launches by caller: {json.dumps(by_caller)}")
    state, _, seen, _ = synced_split(model, state, n_split, name)
    dyn = state.dyn
    for f in DYN_FIELDS:
        require(bool(torch.isfinite(getattr(dyn, f)).all()), f"{name} path: dyn.{f} not finite")
    require(bool(torch.isfinite(state.aero.num).all()), f"{name} path: num not finite")
    require(tuple(state.aero.num.shape) == (nz, ny, nx, 1280), f"{name} path: num shape")
    require(state.step == n_timed + 1 + n_split, f"{name} path: step count")
    require(alive > 0, f"{name} path: no particle alive")
    if name == "mesoscale":
        require(bool(torch.isfinite(state.land.tsk).all()), "mesoscale path: tsk not finite")
        ad = model.aero_data
        salt = (state.aero.vol[..., ad.spec_by_name("Na"), :] > 0) & (state.aero.num > 0)
        salt_num = torch.where(salt, state.aero.num, 0.0).sum(dim=(1, 2, 3))
        added = torch.stack(seen["seasalt"]).sum(0)
        rain = torch.stack(seen["rain"])
        qi, qs = float(dyn.moist[3].max()), float(dyn.moist[4].max())
        print(f"[{name}] sea salt added in {len(seen['seasalt'])} steps, number per level "
              f"{[float(x) for x in added]}; Na+Cl particles' number per level after the "
              f"path {[float(x) for x in salt_num]}; BMJ rain rate max "
              f"{float(rain.max()):.4e} kg m-2 s-1, columns raining {int((rain[-1] > 0).sum())}; WSM5 qi max {qi:.4e}, "
              f"qs max {qs:.4e} kg/kg; skin temperature "
              f"{float(state.land.tsk.min()):.3f}-{float(state.land.tsk.max()):.3f} K")
        require(float(added[0]) > 0.0, "mesoscale path: no sea salt added at level 0")
        require(float(added[1:].abs().max()) == 0.0, "mesoscale path: sea salt added above level 0")
        require(float(salt_num[0]) > 0.0, "mesoscale path: no sea-salt particle at level 0")
        require(float(rain.max()) > 0.0, "mesoscale path: BMJ did not rain")
        require(qi > 0.0 and qs > 0.0, "mesoscale path: WSM5 made no ice or no snow")
    else:
        for label in ("dycore/TKE advance", "dycore/NBA stresses", "dycore/Kessler"):
            require(ran.get(label, 0) > 0, f"LES path: {label} did not run")
        print(f"[{name}] tke {float(dyn.tke.min()):.4e}-{float(dyn.tke.max()):.4e} m2/s2, "
              f"max |w| {float(dyn.w.abs().max()):.4f} m/s, theta' "
              f"{float(dyn.theta_p.min()):.4f}-{float(dyn.theta_p.max()):.4f} K")
        require(float(dyn.tke.max()) > model.cfg.dynamics.tke_seed, "LES path: no TKE grew")
    return shapes


# The file-driven paths (phases 20-23), on the inputs that
# ``wrf_partmc_tpu_torch/tools/sample_inputs.py`` writes under build/.
REAL_DIR = os.path.join(ROOT, "build", "real")


def phase_card_vs_cpu_files():
    """The file-driven build at 12x12x4 (16 per cell, capacity 48), card
    against CPU: ``run.build_model`` with wrfinput + ics + emissions + bcs,
    and with the .spec scenario, on ``cuda`` and on ``cpu``; one step of each
    from the same state, compared by ``compare_card_cpu`` with a floor of
    1e-3 of each field's scale (over the hill the jet turns a small v and
    mu', where the reference's own jitted and eager steps differ by up to
    7.7e-4 of the scale, tests/test_torch_real.py) and the particles to
    rtol 1e-3: the BC background in-mixes (1 - exp(-lam dt)) of its number
    a step, and at mozbc's lam dt = 1e-4 one ulp of float32 exp near 1
    (6e-8) is 6e-4 of that, the card's expf and the CPU's exp differing
    there."""
    from wrf_partmc_tpu_torch import run
    from wrf_partmc_tpu_torch.config import namelist_to_config
    from wrf_partmc_tpu_torch.tools.sample_inputs import (real_namelist, write_real_inputs,
                                                          write_spec_scenario)
    from wrf_partmc_tpu_torch.utils.namelist import parse_namelist

    d = os.path.join(REAL_DIR, "small")
    cfg = namelist_to_config(parse_namelist(real_namelist(12, 12, 4, 16, 48)))
    paths = write_real_inputs(d, cfg)
    paths["spec"] = write_spec_scenario(d, z_top_slab=1000.0, hours=3)
    for label, keys in (("wrfinput+ics+emissions+bcs", ("wrfinput", "ics", "emissions", "bcs")),
                        ("spec", ("spec",))):
        files = {k: paths[k] for k in keys}
        model, state = run.build_model(cfg, input_files=files, device="cpu")
        out_cpu = model(state)
        m_gpu, s_gpu = run.build_model(cfg, input_files=files, device="cuda")
        init = compare_card_cpu(f"card vs CPU, {label} build", s_gpu.to("cpu"), state)
        out_gpu = m_gpu(state.to("cuda")).to("cpu")
        line = compare_card_cpu(f"card vs CPU, {label} step", out_gpu, out_cpu, floor=1e-3,
                                particle_rtol=1e-3)
        print(f"[card-vs-cpu-files] {label} 12x12x4, 16/cell: build {init}; step {line}")


def _file_run(kernels: dict, tag: str, flags: list, steps: int, outdir: str):
    """``run.main`` at the runner's width (40x40x10, 1000 per cell,
    capacity 1280) with ``flags``, history and auxhist2 every 6 steps and
    no restart before the final one; the kernels' counts reset just before
    and read just after, launches attributed to their callers, the initial
    state captured.  Returns (final state, initial state, max |w|, the
    kernels' argument shapes)."""
    import torch

    from wrf_partmc_tpu_torch import run
    from wrf_partmc_tpu_torch.tools.sample_inputs import RUNNER_NAMELIST

    nml = os.path.join(REAL_DIR, "namelist.input")
    with open(nml, "w") as fh:
        fh.write(RUNNER_NAMELIST)

    def configure(cfg):
        return cfg.replace(time_control=dataclasses.replace(
            cfg.time_control, run_seconds=steps * cfg.dynamics.dt, auxhist2_interval_s=60.0,
            restart_interval_s=1e9))
    initial = {}

    def keep_initial(_, fn, args, kwargs):
        model, state = fn(*args, **kwargs)
        initial["state"] = state
        return model, state

    by_caller = {}
    restore = attribute_launches(by_caller, {}, rebalance=True)
    restore_build = patch_sites([(run, "build_model", "build")], keep_initial)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        cs, timers = run.main(["--namelist", nml, "--steps", str(steps), "--outdir", outdir]
                              + flags, configure=configure)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, shapes = read_counts()
    finally:
        restore_build()
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = timers.counts["coupled_step"]
    print(f"[{tag}] 40x40x10, 1000/cell, cap 1280, {steps} steps through run.main "
          f"{' '.join(f.split('/')[-1] for f in flags)}: wall {wall:.3f} s, coupled_step "
          f"{1e3 * timers.totals['coupled_step'] / n:.3f} ms/step over {n} steps, peak "
          f"{peak:.3f} GiB, launches {launches}; files: "
          + _sizes(os.path.join(outdir, f) for f in sorted(os.listdir(outdir))))
    for name in ("partmc_process", "history_write", "restart_write"):
        k, tot = timers.counts[name], timers.totals[name]
        print(f"[{tag}] timer {name}: {k} calls, {tot:.3f} s")
    print(f"[{tag}] kernel launches by caller: {json.dumps(by_caller)}")
    require_launched(kernels, f"launches_{tag}", launches, f"{tag} path", steps)
    dyn = cs.dyn
    for f in DYN_FIELDS:
        require(bool(torch.isfinite(getattr(dyn, f)).all()), f"{tag}: dyn.{f} not finite")
    require(bool(torch.isfinite(cs.aero.num).all()), f"{tag}: num not finite")
    w_max = float(dyn.w.abs().max())
    require(w_max < 5.0, f"{tag}: max |w| {w_max} m/s")       # tests/test_real.py's bound
    require(cs.step == steps, f"{tag}: step {cs.step}")
    return cs, initial["state"], w_max, shapes


def _level_conc(state, grid):
    """Represented number concentration per level [# m-3] of a state."""
    return state.aero.total_num().sum(dim=(1, 2)) / (grid.cell_volume * grid.nx * grid.ny)


def phase_real_path(kernels: dict, steps: int = 12):
    """The real-data path at the runner's width: the inputs written by the
    port's tools at 40x40x10 (each tool timed), then ``run.main`` with
    --wrfinput --ics --emissions --bcs for ``steps`` steps; the represented
    number per level at the start against the ICs' ``dist_number_conc``."""
    from wrf_partmc_tpu_torch.config import namelist_to_config
    from wrf_partmc_tpu_torch.grid import make_grid
    from wrf_partmc_tpu_torch.models.partmc.dist import dist_number_conc
    from wrf_partmc_tpu_torch.tools import make_emissions, make_inputs, mozbc
    from wrf_partmc_tpu_torch.tools.sample_inputs import RUNNER_NAMELIST, write_real_inputs
    from wrf_partmc_tpu_torch.utils.namelist import parse_namelist

    d = os.path.join(REAL_DIR, "full")
    cfg = namelist_to_config(parse_namelist(RUNNER_NAMELIST))
    secs = {}

    def timed(tool, fn, args, kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        secs[tool] = time.perf_counter() - t0
        return out
    restore = patch_sites([(make_inputs, "write_wrfinput", "write_wrfinput"),
                           (make_inputs, "write_ics", "write_ics"),
                           (make_emissions, "convert_smoke", "convert_smoke"),
                           (mozbc, "write_synthetic_mozart", "write_synthetic_mozart"),
                           (mozbc, "run_mozbc", "run_mozbc")], timed)
    try:
        paths = write_real_inputs(d, cfg)
    finally:
        restore()
    print(f"[real] inputs at 40x40x10 by the port's tools: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
          + "; " + _sizes(paths.values()))
    out = os.path.join(REAL_DIR, "out_real")
    flags = [a for k in ("wrfinput", "ics", "emissions", "bcs") for a in (f"--{k}", paths[k])]
    cs, cs0, w_max, shapes = _file_run(kernels, "real", flags, steps, out)
    grid = make_grid(cfg)
    want = dist_number_conc(make_inputs.read_ics(paths["ics"]))
    got = _level_conc(cs0.to("cpu"), grid)
    ratio = got / want
    print(f"[real] represented number at the start / the ICs' dist_number_conc per level: "
          + " ".join(f"{float(r):.6f}" for r in ratio)
          + f"; max |w| {w_max:.4f} m/s, max |mu'| {float(cs.dyn.mu.abs().max()):.3f} Pa, "
          f"alive {int(cs.aero.n_alive().sum())}")
    require(bool(((ratio - 1.0).abs() < 1e-4).all()), f"real: IC number ratio {ratio}")
    shutil.rmtree(out)
    return cs, shapes


def phase_spec_path(kernels: dict, steps: int = 6):
    """The .spec path at the same width: ``run.main(["--spec", ...])`` on a
    scenario written under build/ (two height slabs, 24 hourly emission
    rows) for ``steps`` steps; the per-level IC slabs must land on their
    levels (number concentration and O3 of each level's slab)."""
    import torch

    from wrf_partmc_tpu_torch.config import namelist_to_config
    from wrf_partmc_tpu_torch.grid import make_grid
    from wrf_partmc_tpu_torch.models.partmc.aero_data import make_aero_data
    from wrf_partmc_tpu_torch.models.partmc.dist import dist_number_conc
    from wrf_partmc_tpu_torch.models.partmc.gas_data import make_gas_data
    from wrf_partmc_tpu_torch.tools.sample_inputs import RUNNER_NAMELIST, write_spec_scenario
    from wrf_partmc_tpu_torch.utils import spec_file
    from wrf_partmc_tpu_torch.utils.namelist import parse_namelist

    z_split = 1000.0
    d = os.path.join(REAL_DIR, "spec")
    os.makedirs(d, exist_ok=True)
    spec = write_spec_scenario(d, z_top_slab=z_split, hours=24)
    out = os.path.join(REAL_DIR, "out_spec")
    cs, cs0, w_max, shapes = _file_run(kernels, "spec", ["--spec", spec], steps, out)
    grid = make_grid(namelist_to_config(parse_namelist(RUNNER_NAMELIST)))
    ad, gd = make_aero_data(), make_gas_data()
    slab = [float(dist_number_conc(spec_file.read_aero_dist_dat(os.path.join(d, f), ad)))
            for f in ("aero_init_dist.dat", "aero_init_dist_top.dat")]
    low = grid.z_half < z_split
    want = torch.where(low, slab[0], slab[1])
    got = _level_conc(cs0.to("cpu"), grid)
    o3 = cs0.gas[..., gd.spec_by_name("O3")].to("cpu")
    print(f"[spec] levels below {z_split:.0f} m: {int(low.sum())} of {grid.nz}; number conc "
          f"at the start per level {[f'{float(x):.4e}' for x in got]} against the slabs' "
          f"{slab}; O3 per level {[float(o3[k].mean()) for k in range(grid.nz)]} ppb; max |w| "
          f"{w_max:.4f} m/s, alive {int(cs.aero.n_alive().sum())}")
    require(bool(((got / want - 1.0).abs() < 1e-4).all()), "spec: IC slabs not on their levels")
    require(bool((o3[low] == 50.0).all() and (o3[~low] == 70.0).all()),
            "spec: gas slabs not on their levels")
    require(0 < int(low.sum()) < grid.nz, "spec: both slabs must hold levels")
    shutil.rmtree(out)
    return shapes


def phase_compact(kernels: dict, state):
    """K2 through ``aero_state.compact`` on the real-data path's final
    population ([16000, 33, 1280]): one launch, every field bit-equal to the
    plain scatter through the same pack and unpack, then the kernel, call,
    plain, library and bound times on these indices (``time_scatter``)."""
    import torch

    from wrf_partmc_tpu_torch.models.partmc import aero_state
    from wrf_partmc_tpu_torch.ops import place

    aero = state.aero
    P = aero.capacity
    reset_counts()
    out = aero_state.compact(aero)
    torch.cuda.synchronize()
    launches, _ = read_counts()
    require(launches["scatter_rows"] == 1, f"compact: K2 launched {launches['scatter_rows']}")
    alive = aero.alive
    dst = torch.where(alive, torch.cumsum(alive.to(torch.int32), dim=-1) - 1, -1)
    dst = dst.reshape(-1, P).to(torch.int32).contiguous()
    payload = aero_state.pack_payload(aero)
    ref = aero_state.unpack_payload(aero, place.scatter_rows_plain(payload, dst, P))
    for f in dataclasses.fields(ref):
        require(torch.equal(getattr(out, f.name), getattr(ref, f.name)),
                f"compact: {f.name} differs from the plain version")
    n = alive.sum(-1)
    require(torch.equal(out.alive, torch.arange(P, device=n.device) < n[..., None]),
            "compact: alive slots not first")
    call = call_ms(lambda: aero_state.compact(aero), calls=5)
    res = time_scatter(payload, dst, P, f"compact on the real-data state {list(payload.shape)}")
    print(f"[compact] K2 through aero_state.compact: every field bit-equal to the plain "
          f"version; compact() call {call:.3f} ms; alive {float(alive.float().mean()):.4f} of "
          f"the slots")
    kernels["scatter_rows"]["max_abs_err"] = max(kernels["scatter_rows"].get("max_abs_err", 0.0),
                                                  res["max_abs_err"])
    return res


def phase_urban_plume(kernels: dict):
    """The urban plume through ``box_model.run_box`` on ``cuda``: the
    published 24 h at dt 300 s, P = 2048, n_ideal = 1024 (the tool's
    defaults), with the kernels' counts reset just before and read just
    after; hourly O3, NO, NH3, total number and chi; the trajectory bands
    of tests/test_urban_plume.py."""
    reset_counts()
    res = urban_plume_run(2048, 1024, device="cuda")
    launches, shapes = read_counts()
    T = res["traj"]
    for i in range(len(res["h"])):
        print(f"[plume] {T['t_h'][i]:4.0f} h: O3 {T['O3'][i]:.3f} NO {T['NO'][i]:.4f} NH3 "
              f"{T['NH3'][i]:.4f} ppb, N {T['N_tot'][i]:.4e} m-3, chi {T['chi'][i]:.4f}, "
              f"{T['n_comp'][i]} particles")
    ms = 1e3 * res["seconds"] / res["steps"]
    print(f"[plume] P 2048, n_ideal 1024, {res['steps']} steps of 300 s on cuda: "
          f"{ms:.3f} ms/step ({res['seconds']:.3f} s, observer excluded); chi at 0 h "
          f"{res['chi0']:.4f}; launches {launches}; K3 shapes {sorted(shapes['gather_rows'])}")
    require(launches["gather_rows"] > 0, "plume: K3 was not launched")
    kernels["gather_rows"]["launches_plume"] = launches["gather_rows"]
    require_plume_bands(res)
    print("[plume] the trajectory bands of tests/test_urban_plume.py hold")
    plume_split()
    return shapes


def plume_split(hours: float = 1.0):
    """The box step's sections over the plume's first ``hours``, each
    between two ``torch.cuda.synchronize()``: ms a step of each."""
    import torch

    from wrf_partmc_tpu_torch.models.partmc import box_model
    from wrf_partmc_tpu_torch.tools.urban_plume import build_urban_plume

    aero, gas, scn, benv, ad, gd, mech = build_urban_plume(2048, 1024, device="cuda")
    acc = {}

    def hook(label, fn, args, kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
        return out

    names = ("update_gas_state", "update_aero_state", "coag_step", "mosaic_timestep",
             "equilib_water_hyst", "rebalance")
    restore = patch_sites([(box_model, n, n) for n in names], hook)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box_model.run_box(aero, gas, scn, benv, ad, gd, mech, t_end=hours * 3600.0,
                          dt=PLUME_DT, n_ideal=1024)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        restore()
    steps = round(hours * 3600.0 / PLUME_DT)
    ms = {k: 1e3 * v / steps for k, v in acc.items()}
    print(f"[plume] synced split, {steps} steps: {1e3 * total / steps:.3f} ms/step; "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))
          + f"; the rest {1e3 * total / steps - sum(ms.values()):.3f} (ms/step)")


PLUME_HOURS, PLUME_DT = 24.0, 300.0


def urban_plume_run(P: int = 2048, n_ideal: int = 1024, device="cuda",
                    hours: float = PLUME_HOURS, dt: float = PLUME_DT):
    """The port's urban plume (``tools/urban_plume.py``) through
    ``box_model.run_box`` on ``device``, observed every hour as
    tests/test_urban_plume.py observes it (40 bins from 1 nm to 10 um).
    Returns the trajectories, the hours, chi and the number distribution at
    t = 0, the distributions at hours 6 and 24, the bin centers, the steps,
    and the seconds of the run without its observer."""
    import numpy as np
    import torch

    from wrf_partmc_tpu_torch.models.partmc.bin_grid import make_bin_grid
    from wrf_partmc_tpu_torch.models.partmc.box_model import make_env_state, run_box
    from wrf_partmc_tpu_torch.models.partmc.diagnostics import process
    from wrf_partmc_tpu_torch.tools.urban_plume import build_urban_plume, hourly_row

    aero, gas, scn, benv, ad, gd, mech = build_urban_plume(P, n_ideal, device=device)
    bg = make_bin_grid(40, 1e-9, 1e-5, device=device)
    d0 = process(aero, ad, make_env_state(benv, 0.0, device=device), bg, advanced=False)
    rows, dists, steps, observed = [], {}, [0], [0.0]

    def observe(t, a, g, env):
        steps[0] += 1
        if int(round(t)) % 3600 != 0:
            return
        sync = torch.cuda.synchronize if a.num.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        d = process(a, ad, env, bg, advanced=False)
        if int(round(t / 3600.0)) in (6, 24):
            dists[int(round(t / 3600.0))] = d.num_dist[0, 0, 0].cpu().numpy()
        rows.append(hourly_row(t, a, g, d, ad, gd))
        sync()
        observed[0] += time.perf_counter() - t0

    t0 = time.perf_counter()
    run_box(aero, gas, scn, benv, ad, gd, mech, t_end=hours * 3600.0, dt=dt,
            n_ideal=n_ideal, observer=observe)
    if aero.num.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traj = {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
    return dict(traj=traj, h=traj["t_h"], chi0=float(d0.chi[0, 0, 0]),
                d0=d0.num_dist[0, 0, 0].cpu().numpy(), dists=dists,
                centers=bg.centers.cpu().numpy(), steps=steps[0],
                seconds=wall - observed[0])


def require_plume_bands(res) -> None:
    """The trajectory bands of tests/test_urban_plume.py::
    test_urban_plume_24h_trajectories (Riemer et al. 2009; Riemer & West
    2013), each with its published anchor there."""
    import numpy as np

    T, h = res["traj"], res["h"]
    require(res["chi0"] > 0.9, f"plume: initial population not internally mixed, chi "
            f"{res['chi0']}")
    require(len(h) == 24, f"plume: {len(h)} hourly rows")
    o3 = T["O3"]
    i_pk = int(np.argmax(o3))
    require(65.0 <= o3[i_pk] <= 170.0, f"plume: O3 peak {o3[i_pk]}")
    require(4.0 <= h[i_pk] <= 13.0, f"plume: O3 peak hour {h[i_pk]}")
    require(o3[-1] < o3[i_pk], "plume: no nocturnal O3 decline")
    require(20.0 <= o3[-1] <= 110.0, f"plume: O3 at 24 h {o3[-1]}")
    require(T["NH3"].min() < 0.3, f"plume: NH3 never depleted, min {T['NH3'].min()}")
    require(1.0 <= T["HNO3"].max() <= 25.0, f"plume: HNO3 max {T['HNO3'].max()}")
    night = h >= 12.0
    require(T["N2O5"][night].max() > 0.02, "plume: no nocturnal N2O5")
    require(T["NO"][night].max() < 1.0, "plume: NO not titrated at night")
    n = T["N_tot"]
    require(6.0e9 <= n.max() <= 4.0e10, f"plume: N max {n.max()}")
    require(1.5e9 <= n[-1] <= 1.2e10, f"plume: N(24 h) {n[-1]}")
    require(n[-1] < 0.75 * n.max(), "plume: no number decay")
    require(T["no3_ug"].max() > 0.3, f"plume: no particulate NO3 ({T['no3_ug'].max()})")
    require(T["pm25"].min() > 1.0, f"plume: PM2.5 min {T['pm25'].min()}")
    c, d0, dists = res["centers"], res["d0"], res["dists"]
    uf = (c > 2e-8) & (c < 1e-7)
    acc = (c > 1e-7) & (c < 5e-7)
    require(d0[uf].max() > 0 and d0[acc].max() > 0, "plume: initial dist not bimodal")
    require(8e-9 < c[int(np.argmax(d0))] < 8e-8, "plume: initial peak not in the Aitken range")
    require(6 in dists and 24 in dists, "plume: no distribution at hours 6 and 24")
    require(dists[6][uf].sum() > 1.2 * dists[24][uf].sum(),
            f"plume: ultrafine number {dists[6][uf].sum()} at 6 h, {dists[24][uf].sum()} at 24 h")
    require(dists[24][acc].sum() > 0.1 * dists[6][acc].sum(), "plume: accumulation mode lost")
    chi = T["chi"]
    require(0.30 <= chi.min() <= 0.80, f"plume: chi min {chi.min()}")
    require(chi.min() < res["chi0"] - 0.15, "plume: emissions never de-mixed the population")
    require(chi[h >= 18.0].mean() > chi.min(), "plume: no aging recovery of chi")


def count_callers(by_caller: dict, sites):
    """Count, per caller label, the launches of the kernel named in each
    (module, attribute, label, kernel) site made inside those calls.
    Returns a function that restores the modules."""
    fns = _kernel_fns()
    kernel_of = {label: kernel for _, _, label, kernel in sites}
    by_caller.update({label: 0 for label in kernel_of})

    def hook(label, fn, args, kwargs):
        before = fns[kernel_of[label]].launches
        out = fn(*args, **kwargs)
        by_caller[label] += fns[kernel_of[label]].launches - before
        return out
    return patch_sites([site[:3] for site in sites], hook)


def _linear_sites():
    from wrf_partmc_tpu_torch.models.dycore import solve
    from wrf_partmc_tpu_torch.ops import vdiff

    return [(solve, "tridiag_solve", "K1 in the linear acoustic", "thomas_solve"),
            (vdiff, "solve_fields", "K1 in vertical diffusion", "thomas_solve")]


def _rebucket_sites(label: str):
    from wrf_partmc_tpu_torch.models.coupled import transport
    from wrf_partmc_tpu_torch.models.partmc import coag

    return [(transport, "scatter_rows", f"K2 in the {label} rebucket", "scatter_rows"),
            (transport, "gather_rows", f"K3 in the {label} rebucket", "gather_rows"),
            (coag, "gather_rows", "K3 in coagulation", "gather_rows")]


def phase_card_vs_cpu_linear():
    from wrf_partmc_tpu_torch.entry import build

    model, state = build(12, 12, 4, n_part=16, cap=48, dyn_opt="linear", device="cpu")
    require(state.dyn.mu is None and state.dyn.ph is None, "linear: the state has mu/ph")
    out_cpu = model(state)
    out_gpu = model.to("cuda")(state.to("cuda")).to("cpu")
    print("[linear-card-vs-cpu] 12x12x4, 16/cell, dyn_opt linear: "
          + compare_card_cpu("linear card vs CPU", out_gpu, out_cpu))


def phase_linear_path(kernels: dict, n_timed: int = 6):
    """The em_uniform main path on the linear core."""
    import torch

    from wrf_partmc_tpu_torch.entry import build
    from wrf_partmc_tpu_torch.models.dycore import solve

    t0 = time.perf_counter()
    model, state = build(40, 40, 10, n_part=1000, cap=1280, dyn_opt="linear", device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    by_caller = {}
    restore = count_callers(by_caller, _linear_sites() + _rebucket_sites("single-device"))
    box, state = [state], None          # drive holds the only reference
    solve.reset_graph_counts()
    state, warm, dt, launches, shapes = drive(model, box, n_timed)
    restore()
    graph = solve.read_graph_counts()
    steps = n_timed + 1
    ms = 1e3 * dt / n_timed
    PATH_MS["linear path"] = ms
    print(f"[linear] 40x40x10, 1000/cell, cap 1280, dyn_opt linear, n_sound "
          f"{model.cfg.dynamics.n_sound}: build {build_s:.3f} s; warm-up {1e3 * warm:.3f} ms; "
          f"{n_timed} timed steps {1e3 * dt:.3f} ms = {ms:.3f} ms/step (phase 5's ARW "
          f"{PATH_MS.get('main path', float('nan')):.3f}); alive "
          f"{int(state.aero.n_alive().sum())}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches a step "
          + json.dumps({k: v / steps for k, v in launches.items()}))
    print(f"[linear] kernel launches by caller in {steps} steps: {json.dumps(by_caller)}")
    require(state.dyn.mu is None, "linear path: mu appeared")
    require(bool(torch.isfinite(state.dyn.w).all()), "linear path: w not finite")
    require(bool(torch.isfinite(state.aero.num).all()), "linear path: num not finite")
    ns = model.cfg.dynamics.n_sound
    per = 1 + max(1, ns // 2) + ns
    # a replayed dycore graph launches K1 without calling its wrapper: the
    # wrapper runs in the eager steps and in the one captured
    traced = graph["eager"] + graph["captures"]
    require(traced + graph["replays"] == steps, f"linear path: dycore calls {graph}")
    require(by_caller["K1 in the linear acoustic"] == per * traced,
            f"linear path: K1 in the acoustic {by_caller['K1 in the linear acoustic']}, "
            f"want {per} a step in the {traced} steps not replayed ({graph})")
    require_launched(kernels, "launches_linear", launches, "linear path", steps)
    kernels["thomas_solve"]["launches_linear_acoustic"] = by_caller["K1 in the linear acoustic"]
    return shapes


RDV_DIR = os.path.join(ROOT, "build", "rendezvous")


def start_world(device: str, n: int = 1, rank: int = 0, path: str | None = None):
    """A process group of ``n`` ranks (NCCL on ``cuda``, gloo on ``cpu``) on
    a file rendezvous under ``build/``; returns the path for the others."""
    from wrf_partmc_tpu_torch.parallel import distributed as pdist

    os.makedirs(RDV_DIR, exist_ok=True)
    if path is None:
        path = os.path.join(RDV_DIR, f"{device}-{os.getpid()}-{time.monotonic_ns()}")
    pdist.init(f"file://{path}", n, rank, device, timeout_s=300)
    return path


def stop_world(path: str | None):
    from wrf_partmc_tpu_torch.parallel import distributed as pdist

    pdist.shutdown()
    if path and os.path.exists(path):
        os.remove(path)


# phase 27's decomposed steps: path -> (nx, ny, nz, particles per cell,
# capacity)
SMALL_DECOMPOSED = {"em_uniform": (12, 12, 4, 16, 48), "mesoscale": (12, 12, 4, 16, 32),
                    "les": (12, 12, 8, 16, 32), "cares": (12, 10, 8, 16, 32)}


def build_path(kind: str, nx: int, ny: int, nz: int, n_part: int, cap: int, device,
               mesh=None):
    """The model and state of a decomposed path: em_uniform (``entry.build``),
    an option set (``build_option_set``; the mesoscale particles' tails
    lifted, with a mesh or without) or the CARES shape
    (``cares.build_cares_shape``, chemistry on); with ``mesh``, this rank's
    part of it."""
    if kind == "em_uniform":
        from wrf_partmc_tpu_torch.entry import build

        return build(nx, ny, nz, n_part=n_part, cap=cap, device=device, mesh=mesh)
    if kind == "cares":
        from wrf_partmc_tpu_torch.cares import build_cares_shape

        return build_cares_shape(nx, ny, nz, n_part=n_part, cap=cap, device=device, mesh=mesh)
    from wrf_partmc_tpu_torch.option_sets import OPTION_SETS, build_option_set, lift_tails

    model, state = build_option_set(kind, nx, ny, nz, n_part, cap, device=device, mesh=mesh)
    lift = mesh is None and OPTION_SETS[kind].lift_tails
    return model, (lift_tails(state) if lift else state)


def rank_step(path: str, kind: str = "em_uniform"):
    """One rank of a started world: one decomposed step of path ``kind`` at
    its ``SMALL_DECOMPOSED`` size, its state, its block's place and
    collective counts saved to ``path.<rank>`` on the CPU."""
    import torch

    from wrf_partmc_tpu_torch.parallel import distributed as pdist, halo

    mesh = pdist.global_mesh()
    nx, ny, nz, n_part, cap = SMALL_DECOMPOSED[kind]
    model, state = build_path(kind, nx, ny, nz, n_part, cap, mesh.device, mesh)
    halo.reset_counts()
    reset_counts()
    out = model(state).to("cpu")
    launches, shapes = read_counts()
    ys, xs = mesh.slices(ny, nx)
    torch.save({"state": out, "counts": halo.read_counts(), "ys": ys, "xs": xs,
                "optics": {name: (launches[name], sorted(shapes[name]))
                           for name in OPTICS_KERNELS}}, f"{path}.{mesh.rank}")


def spawn_ranks(n: int, device: str, call: str, timeout_s: float = 600.0) -> list:
    """Run ``chip_smoke.<call>`` on each of ``n`` ranks of a new ``device``
    world started by ``parallel.launch.spawn``; returns each rank's
    output, failing the phase if a rank fails."""
    from wrf_partmc_tpu_torch.parallel.launch import spawn

    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as c; "
            "from wrf_partmc_tpu_torch.parallel import distributed as d; "
            f"d.init_from_env({device!r}); c.{call}; d.shutdown()")
    env = None
    if device == "cpu":
        # CPU ranks share the host's cores: each takes its share of the
        # threads (torch's and the BLAS's of the Mie fit's lstsq)
        share = str(max(1, (os.cpu_count() or 1) // n))
        env = dict(os.environ, OMP_NUM_THREADS=share, OPENBLAS_NUM_THREADS=share,
                   MKL_NUM_THREADS=share)
    results = spawn(n, [sys.executable, "-c", code], timeout_s=timeout_s, env=env, cwd=ROOT)
    bad = [(r, c, out[-2000:]) for r, (c, out) in enumerate(results) if c != 0]
    require(not bad, f"{n} {device} ranks failed: {bad}")
    return [out for _, out in results]


BLOCK_TOL = 1e-4      # share of a field's scale a decomposed block may differ by


def hold_blocks(tag: str, whole, rank_out) -> str:
    """Hold a rank's block of every dycore field against the same block of
    the undecomposed step (both on the card): bit-equal, or within
    ``BLOCK_TOL`` of the field's scale (ATen may sum the levels of a
    block's columns in another order than the whole domain's).  Returns
    the fields that differ with their largest difference."""
    import torch

    diffs = {}
    for name in DYN_FIELDS:
        w = getattr(whole.dyn, name)
        b = getattr(rank_out["state"].dyn, name)
        if w is None:
            require(b is None, f"{tag}: dyn.{name} only on the block")
            continue
        w = w[..., rank_out["ys"], rank_out["xs"]]
        require(b.shape == w.shape, f"{tag}: dyn.{name} block {tuple(b.shape)} vs "
                f"{tuple(w.shape)}")
        if not torch.equal(b, w):
            d = float((b - w).abs().max())
            require(d <= BLOCK_TOL * float(w.abs().max()),
                    f"{tag}: dyn.{name} block differs by {d}")
            diffs[name] = d
    return ("bit-equal" if not diffs else "within 1e-4 of the scale: " + " ".join(
        f"{k}={v:.2e}" for k, v in diffs.items()))


def phase_card_vs_cpu_decomposed(kernels: dict):
    """For each ``SMALL_DECOMPOSED`` path (em_uniform, the two option sets,
    the CARES shape): a world of one over NCCL on the card, then one over
    gloo on the CPU, one decomposed step each; with more cards visible (up
    to 4), the same over ``factor_2d(n)`` ranks, block by block.  Each card
    rank's dycore block against the undecomposed step on the card.  Each
    CARES card rank launched K5 once, held at its block's shape."""
    import torch

    from wrf_partmc_tpu_torch.parallel.mesh import factor_2d

    os.makedirs(RDV_DIR, exist_ok=True)
    ns = sorted({1, min(4, torch.cuda.device_count())})
    for kind, (nx, ny, nz, n_part, cap) in SMALL_DECOMPOSED.items():
        model, state = build_path(kind, nx, ny, nz, n_part, cap, "cuda")
        whole = model(state).to("cpu")
        del model, state
        size = f"{nx}x{ny}x{nz}, {n_part}/cell"
        for n in ns:
            outs = {}
            for dev in ("cuda", "cpu"):
                path = os.path.join(RDV_DIR, f"step-{kind}-{dev}-{n}")
                if n == 1:
                    world = start_world(dev)
                    try:
                        rank_step(path, kind)
                    finally:
                        stop_world(world)
                else:
                    spawn_ranks(n, dev, f"rank_step({path!r}, {kind!r})")
                outs[dev] = [torch.load(f"{path}.{r}", weights_only=False) for r in range(n)]
                for r in range(n):
                    os.remove(f"{path}.{r}")
            py, px = factor_2d(n)
            for r in range(n):
                a, b = outs["cuda"][r], outs["cpu"][r]
                tag = f"decomposed {kind} card vs CPU, rank {r} of {n}"
                require(a["counts"] == b["counts"] and a["counts"]["all_gather"]["calls"] == 0
                        and (n == 1 or a["counts"]["p2p"]["calls"] > 0),
                        f"{tag}: collectives {a['counts']} vs {b['counts']}")
                extra = ""
                if kind == "cares":
                    k5_launches, k5_shapes = a["optics"]["mie_fit_bulk"]
                    require(k5_launches == 1 and b["optics"]["mie_fit_bulk"][0] == 0,
                            f"{tag}: K5 launched {k5_launches} times on the card, "
                            f"{b['optics']['mie_fit_bulk'][0]} on the CPU")
                    phase_path_shapes(f"{tag}, K5", kernels,
                                      {"mie_fit_bulk": {_tuplify(sh) for sh in k5_shapes}})
                    ga, gb = a["state"].gas, b["state"].gas
                    g_rel = float(((ga - gb).abs() / (gb.abs() + 1e-9)).max())
                    require(torch.allclose(ga, gb, rtol=1e-4, atol=1e-9),
                            f"{tag}: gases max rel {g_rel}")
                    extra = f"gases max rel {g_rel:.2e}; "
                print(f"[decomposed-card-vs-cpu] {kind} {size}, {n} rank(s), mesh {py}x{px}, "
                      f"rank {r} (NCCL on cuda vs gloo on cpu): {extra}"
                      + compare_card_cpu(tag, a["state"], b["state"],
                                         floor=5e-4 if kind == "les" else 1e-4)
                      + f"; collectives {json.dumps(a['counts'])}")
                print(f"[decomposed-blocks] {kind} {size}, {n} rank(s), rank {r}'s dycore "
                      f"block (NCCL, card) against the undecomposed step on the card: "
                      + hold_blocks(f"decomposed {kind} block, rank {r} of {n}", whole, a))


def _block_sites():
    from wrf_partmc_tpu_torch.models.dycore import arw
    from wrf_partmc_tpu_torch.ops import vdiff

    return [(arw, "tridiag_solve", "K1 in the block ARW acoustic", "thomas_solve"),
            (vdiff, "solve_fields", "K1 in block vertical diffusion", "thomas_solve")]


def _path_sites(kind: str):
    """The caller sites a decomposed path counts launches in: the rank-local
    rebucket's and coagulation's K2/K3, the block dycore's and vertical
    diffusion's K1, and per path K1 in MYJ and Noah (CARES) or K3 in the
    particle rebalance and its ``split_largest`` (the option sets)."""
    from wrf_partmc_tpu_torch.models.coupled import driver
    from wrf_partmc_tpu_torch.models.partmc import aero_state
    from wrf_partmc_tpu_torch.models.physics import lsm, myj

    sites = _rebucket_sites("rank-local") + _block_sites()
    if kind == "cares":
        sites += [(myj, "tridiag_solve", "K1 in block MYJ", "thomas_solve"),
                  (lsm, "tridiag_solve", "K1 in block Noah", "thomas_solve")]
    elif kind != "em_uniform":
        sites += [(driver, "rebalance", "K3 in rebalance", "gather_rows"),
                  (aero_state, "split_largest", "K3 in rebalance/split_largest",
                   "gather_rows")]
    return sites


def decomposed_run(nx: int = 40, ny: int = 40, n_timed: int = 6, n_split: int = 2,
                   report: bool = False, kind: str = "em_uniform", nz: int = 10,
                   n_part: int = 1000, cap: int = 1280, save_first: str | None = None) -> dict:
    """This rank's share of phases 28 and 29 in a world of n ranks: the
    decomposed path ``kind`` (``build_path``) at nx x ny x nz, ``n_part``
    per cell, a warm-up and ``n_timed`` timed steps, a synced split of
    ``n_split`` steps (the halo exchanges and the transport's P2P timed
    inside the sections), then for em_uniform ``entry.dryrun_multichip(n)``.
    With ``save_first``, the dycore state after the warm-up step and the
    block's place go to ``save_first.<rank>`` on the CPU.  Returns its
    report (shapes as lists); with ``report``, every rank also prints it as
    JSON."""
    import torch
    import torch.distributed as dist

    from wrf_partmc_tpu_torch.entry import dryrun_multichip
    from wrf_partmc_tpu_torch.parallel import distributed as pdist, halo

    n = dist.get_world_size()
    mesh = pdist.global_mesh()
    torch.cuda.set_device(mesh.device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state = build_path(kind, nx, ny, nz, n_part, cap, mesh.device, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    by_caller, draws = {}, {}
    restore = count_callers(by_caller, _path_sites(kind))
    restore_draws = record_draws(draws)
    state = model(state)
    if save_first is not None:
        ys, xs = mesh.slices(ny, nx)
        torch.save({"state": dataclasses.replace(state, aero=None, gas=None).to("cpu"),
                    "ys": ys, "xs": xs}, f"{save_first}.{mesh.rank}")
    torch.cuda.synchronize()
    halo.reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state = model(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    restore_draws()
    restore()
    counts = halo.read_counts()
    launches, shapes = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    alive = int(halo.all_reduce_sum(state.aero.n_alive().sum().to(torch.float32), mesh))
    finite = bool(torch.isfinite(state.aero.num).all() and torch.isfinite(state.dyn.theta_p).all())
    diag = {k: float(v) for k, v in model.last_diag.items()}
    dist.barrier()
    state, _, _, split = synced_split(model, state, n_split,
                                      f"decomposed {kind} rank {mesh.rank}",
                                      extra=((halo, "pad_axis", "*/halo exchanges"),
                                             (halo, "_p2p", "*/P2P")))
    state, split_draws = draw_split(f"decomposed {kind} rank {mesh.rank}", model, state,
                                    echo=False)
    dry = dryrun_multichip(n, device="cuda")["collectives"] if kind == "em_uniform" else None
    rep = dict(n=n, mesh=list(mesh.shape), rank=mesh.rank, kind=kind, nx=nx, ny=ny, nz=nz,
               build_s=build_s, build_peak_gib=build_peak, ms=1e3 * dt / n_timed,
               steps=n_timed + 1, peak_gib=peak, alive=alive, finite=finite, diag=diag,
               by_caller=by_caller, launches=launches,
               shapes={k: [list(map(_listify, sh)) for sh in v] for k, v in shapes.items()},
               collectives={k: {f: v / n_timed for f, v in rec.items() if f != "max_bytes"}
                            | {"max_bytes": rec["max_bytes"]} for k, rec in counts.items()},
               block=list(state.aero.num.shape), dyn_block=list(state.dyn.theta_p.shape),
               split=split, draws=split_draws,
               draw_keys=[[_listify(k), c] for k, c in draws.items()], dryrun=dry)
    if report:
        print("REPORT " + json.dumps(rep), flush=True)
    return rep


def _listify(x):
    return [_listify(v) for v in x] if isinstance(x, (tuple, list)) else x


def _tuplify(x):
    return tuple(_tuplify(v) for v in x) if isinstance(x, list) else x


def run_decomposed_world(n: int, nx: int, ny: int, **kw) -> list:
    """Every rank's report of ``decomposed_run(nx, ny, **kw)`` on n cards."""
    if n == 1:
        path = start_world("cuda")
        try:
            return [decomposed_run(nx, ny, **kw)]
        finally:
            stop_world(path)
    args = "".join(f", {k}={v!r}" for k, v in kw.items())
    outs = spawn_ranks(n, "cuda", f"decomposed_run({nx}, {ny}, report=True{args})")
    return [json.loads(next(line[7:] for line in out.splitlines()
                            if line.startswith("REPORT "))) for out in outs]


def rank_draws(path: str, reps: list) -> None:
    """Each rank's synced draws (``draw_split``), and rank 0's launches and
    draws by K4 argument key."""
    rep = reps[0]
    PATH_LAUNCHES[path] = (rep["launches"], rep["steps"])
    DRAWS[path] = ({_tuplify(k): c for k, c in rep["draw_keys"]}, rep["steps"], rep["ms"])
    for r in reps:
        DRAW_SPLITS[f"{path}, rank {r['rank']}"] = r["draws"]
        print(f"[draws] {path}, rank {r['rank']}, 2 steps each with synced draws: "
              + split_text(r["draws"]))


def phase_decomposed_path(kernels: dict):
    import torch

    from wrf_partmc_tpu_torch.parallel.mesh import factor_2d

    n = min(4, torch.cuda.device_count())
    py, px = factor_2d(n)
    main_ms = PATH_MS.get("main path", float("nan"))
    runs = [("strong", 40, 40)] + ([("weak", 40 * px, 40 * py)] if n > 1 else [])
    shapes = {}
    for kind, nx, ny in runs:
        reps = run_decomposed_world(n, nx, ny)
        rep = reps[0]
        for k, v in rep["shapes"].items():
            shapes.setdefault(k, set()).update(_tuplify(sh) for sh in v)
        steps = rep["steps"]
        slowest = max(r["ms"] for r in reps)
        print(f"[decomposed] {kind} scaling, n {n} (mesh {py}x{px}; each rank's block "
              f"{rep['block']}): {nx}x{ny}x10, 1000/cell, cap 1280: build "
              f"{rep['build_s']:.3f} s; {rep['ms']:.3f} ms/step on rank 0 (slowest rank "
              f"{slowest:.3f}) against phase 5's undecomposed 40x40x10 {main_ms:.3f} "
              f"({rep['ms'] / main_ms:.4f}x); max_memory_allocated "
              + " ".join(f"{r['peak_gib']:.3f}" for r in reps)
              + f" GiB by rank; alive {rep['alive']}; transport diag {json.dumps(rep['diag'])}")
        c = rep["collectives"]
        print(f"[decomposed] {kind}: collectives a step: halo calls {c['halo']['calls']:g} "
              f"({c['halo']['bytes']:.0f} halo bytes), P2P sends {c['p2p']['calls']:g} "
              f"({c['p2p']['bytes']:.0f} bytes, largest {c['p2p']['max_bytes']}), all-gathers "
              f"{c['all_gather']['calls']:g}, all-reduces {c['all_reduce']['calls']:g} "
              f"({c['all_reduce']['bytes']:.0f} bytes)")
        print(f"[decomposed] {kind}: launches a step "
              + json.dumps({k: v / steps for k, v in rep["launches"].items()})
              + f"; by caller in {steps} steps: {json.dumps(rep['by_caller'])}")
        for r in reps:
            sp = r["split"]
            top = {k: v for k, v in sp.items() if "/" not in k and k != "synced step"}
            print(f"[decomposed] {kind}: rank {r['rank']} synced split (ms/step): step "
                  f"{sp['synced step']:.3f}; " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(top.items(), key=lambda kv: -kv[1]))
                  + f"; inside them the halo exchanges {sp.get('*/halo exchanges', 0.0):.3f}"
                  f" (their P2P and the transport's {sp.get('*/P2P', 0.0):.3f})")
        rank_draws(f"decomposed {kind} path", reps)
        print(f"[decomposed] {kind}: dryrun_multichip({rep['n']}) OK, collectives "
              + json.dumps(rep["dryrun"]))
        require(all(r["finite"] for r in reps), f"decomposed {kind} path: not finite")
        require(rep["alive"] > 0, f"decomposed {kind} path: no particle alive")
        require(all(r["collectives"]["all_gather"]["calls"] == 0 for r in reps),
                f"decomposed {kind} path: a field was gathered")
        require(n == 1 or c["p2p"]["calls"] > 0, f"decomposed {kind} path: no halo exchange")
        require(rep["dyn_block"] == [10, ny // py, nx // px],
                f"decomposed {kind} path: the dycore block is {rep['dyn_block']}")
        if kind == "strong":
            for name, rec in kernels.items():
                if name in OPTICS_KERNELS:
                    continue
                rec["launches_decomposed"] = rep["launches"][name]
                require(rec["launches_decomposed"] > 0,
                        f"{name} was not launched on the decomposed path")
            kernels["thomas_solve"]["launches_block_acoustic"] = \
                rep["by_caller"]["K1 in the block ARW acoustic"]
            kernels["thomas_solve"]["launches_block_vdiff"] = \
                rep["by_caller"]["K1 in block vertical diffusion"]
            kernels["scatter_rows"]["launches_rank_local_rebucket"] = \
                rep["by_caller"]["K2 in the rank-local rebucket"]
            kernels["gather_rows"]["launches_rank_local_rebucket"] = \
                rep["by_caller"]["K3 in the rank-local rebucket"]
        else:
            kernels["thomas_solve"]["launches_decomposed_weak"] = rep["launches"]["thomas_solve"]
        PATH_MS[f"decomposed {kind}"] = rep["ms"]
    # the rank-local rebucket's block shapes, held and timed here even
    # where an earlier path held them (on one card the block is the domain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name in ("scatter_rows", "gather_rows"):
        for sh in sorted(shapes[name], key=repr):
            hold(kernels, gen, name, sh)
    torch.cuda.empty_cache()
    return shapes


# phase 29's paths: (path, scaling, nx, ny, nz, particles per cell,
# capacity); the weak runs' nx, ny are each rank's block
DECOMPOSED_PATHS = (("mesoscale", "strong", 40, 40, 10, 1000, 1280),
                    ("les", "strong", 40, 40, 16, 1000, 1280),
                    ("cares", "strong", 72, 72, 24, 100, 128),
                    ("cares", "weak", 72, 72, 24, 100, 128))
FIRST_DIR = os.path.join(ROOT, "build", "first_step")


def one_card_run(kind: str, nx: int, ny: int, nz: int, n_part: int, cap: int,
                 n_timed: int = 6):
    """The undecomposed path on this process's card, as phase 29 times the
    decomposed one: a warm-up and ``n_timed`` timed steps.  Returns (ms/step,
    peak GiB, launches a step, the dycore state after the warm-up step on
    the CPU)."""
    import torch

    _free()
    torch.cuda.reset_peak_memory_stats()
    model, state = build_path(kind, nx, ny, nz, n_part, cap, "cuda")
    reset_counts()
    state = model(state)
    first = dataclasses.replace(state, aero=None, gas=None).to("cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state = model(state)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n_timed
    launches, _ = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, state
    _free()
    return ms, peak, {k: v / (n_timed + 1) for k, v in launches.items()}, first


def phase_decomposed_options(kernels: dict):
    """Phase 29: the option sets and the CARES shape decomposed over
    ``factor_2d(n)`` ranks (n the visible cards, up to 4), each beside the
    undecomposed path on one card in the same call: ms/step, peak memory a
    card (build and steps), the collectives a step with their bytes, the
    kernels' launches a step and by caller, a synced split per rank with
    the halo exchanges timed inside; the CARES strong run's dycore blocks
    after one step against the one-card step's.  Every kernel is then held
    at the shapes these paths launched."""
    import torch

    from wrf_partmc_tpu_torch.parallel.mesh import factor_2d

    n = min(4, torch.cuda.device_count())
    py, px = factor_2d(n)
    os.makedirs(FIRST_DIR, exist_ok=True)
    one = {}
    all_shapes = {}
    for kind, scaling, nx, ny, nz, n_part, cap in DECOMPOSED_PATHS:
        if scaling == "weak" and n == 1:
            continue
        if kind not in one:                     # the strong run's domain on one card
            one[kind] = one_card_run(kind, nx, ny, nz, n_part, cap)
        ms1, peak1, launches1, first1 = one[kind]
        if scaling == "weak":
            nx, ny = nx * px, ny * py
        save = os.path.join(FIRST_DIR, kind) if (kind, scaling) == ("cares", "strong") else None
        reps = run_decomposed_world(n, nx, ny, kind=kind, nz=nz, n_part=n_part, cap=cap,
                                    save_first=save)
        rep = reps[0]
        label = f"{kind} {scaling}"
        tag = f"[decomposed-{kind}] {scaling}"
        steps = rep["steps"]
        c = rep["collectives"]
        print(f"{tag}, n {n} (mesh {py}x{px}; each rank's block {rep['block']}): "
              f"{nx}x{ny}x{nz}, {n_part}/cell, cap {cap}: build {rep['build_s']:.3f} s; "
              f"{rep['ms']:.3f} ms/step on rank 0 (ranks "
              + " ".join(f"{r['ms']:.3f}" for r in reps)
              + f") against the undecomposed path's {ms1:.3f} on one card in this call "
              f"({rep['ms'] / ms1:.4f}x); peak "
              "GiB a card, build / steps: "
              + " ".join(f"{r['build_peak_gib']:.3f}/{r['peak_gib']:.3f}" for r in reps)
              + f" (one card: {peak1:.3f}); alive {rep['alive']}; transport diag "
              + json.dumps(rep["diag"]))
        print(f"{tag}: collectives a step: halo calls {c['halo']['calls']:g} "
              f"({c['halo']['bytes']:.0f} halo bytes), P2P sends {c['p2p']['calls']:g} "
              f"({c['p2p']['bytes']:.0f} bytes, largest {c['p2p']['max_bytes']}), all-gathers "
              f"{c['all_gather']['calls']:g}, all-reduces {c['all_reduce']['calls']:g} "
              f"({c['all_reduce']['bytes']:.0f} bytes)")
        print(f"{tag}: launches a step "
              + json.dumps({k: v / steps for k, v in rep["launches"].items()})
              + f" (one card {json.dumps(launches1)}); by caller in {steps} steps: "
              + json.dumps(rep["by_caller"]))
        for r in reps:
            sp = r["split"]
            top = {k: v for k, v in sp.items() if "/" not in k and k != "synced step"}
            print(f"{tag}: rank {r['rank']} synced split (ms/step): step "
                  f"{sp['synced step']:.3f}; " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(top.items(), key=lambda kv: -kv[1]))
                  + f"; inside them the halo exchanges {sp.get('*/halo exchanges', 0.0):.3f}"
                  f" (their P2P and the transport's {sp.get('*/P2P', 0.0):.3f})")
        rank_draws(f"decomposed {label} path", reps)
        require(all(r["finite"] for r in reps), f"decomposed {label}: not finite")
        require(rep["alive"] > 0, f"decomposed {label}: no particle alive")
        require(all(r["collectives"]["all_gather"]["calls"] == 0 for r in reps),
                f"decomposed {label}: a field was gathered")
        require(n == 1 or c["p2p"]["calls"] > 0, f"decomposed {label}: no halo exchange")
        require(rep["dyn_block"] == [nz, ny // py, nx // px],
                f"decomposed {label}: the dycore block is {rep['dyn_block']}")
        for name, rec in kernels.items():
            if name in OPTICS_KERNELS and kind != "cares":
                continue
            rec[f"launches_decomposed_{kind}_{scaling}"] = rep["launches"][name]
            require(rep["launches"][name] > 0, f"{name} was not launched on the decomposed "
                    f"{label} path")
        if kind == "cares":
            for name in OPTICS_KERNELS:       # set by the CARES path where it ran
                kernels[name].setdefault("launches", rep["launches"][name])
        for caller, count in rep["by_caller"].items():
            require(count > 0 or "K3" in caller,
                    f"decomposed {label}: no kernel launch from {caller}")
        PATH_MS[f"decomposed {label}"] = rep["ms"]
        if save is not None:
            for r in range(n):
                out = torch.load(f"{save}.{r}", weights_only=False)
                os.remove(f"{save}.{r}")
                print(f"{tag}: rank {r}'s dycore block after one step against the one-card "
                      "step's: " + hold_blocks(f"decomposed {label}, rank {r}", first1, out))
        for k, v in rep["shapes"].items():
            all_shapes.setdefault(k, set()).update(_tuplify(sh) for sh in v)
    return all_shapes


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


# the first point of each sweep of the bench's full preset, which every
# worker must reach on 80 GB
BENCH_FIRST_POINTS = {"coupled_num_particles_per_cell": 1000,
                      "coupled_chem_on_particles_per_cell": 100,
                      "coupled_40class_particles_per_cell": 1000,
                      "cares_shape_grid": "72x72x24"}
BENCH_TIMEOUT_S = 600
BENCH_DYCORE = (128, 128, 40)


def _numbers(v):
    if isinstance(v, dict):
        for x in v.values():
            yield from _numbers(x)
    elif isinstance(v, list):
        for x in v:
            yield from _numbers(x)
    elif not isinstance(v, str):
        yield v


def phase_bench(kernels: dict):
    """``python -m wrf_partmc_tpu_torch.bench --preset full`` in its own
    process group (killed whole after ``BENCH_TIMEOUT_S``): exit 0, the
    first sweep point taken everywhere, every number finite and positive,
    the card and its power limit named, the kernels launched by every
    worker (the dycore's K1; K1, K2 and K3 in the others).  Then the dycore
    worker's model built here at 128x128x40 and stepped twice, with K1's
    launches counted, and K1 held at every shape it gave."""
    import signal

    import torch

    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-m", "wrf_partmc_tpu_torch.bench", "--preset",
                          "full"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        raise SmokeFailure(f"bench: killed after {BENCH_TIMEOUT_S} s; stdout: {out[-3000:]}; "
                           f"stderr: {err[-3000:]}")
    wall = time.perf_counter() - t0
    lines = out.strip().splitlines()
    for line in lines:
        print(line if line.startswith("[bench]") else f"[bench] {line}")
    require(p.returncode == 0 and lines, f"bench: return code {p.returncode}; stderr: "
            f"{err[-3000:]}")
    res = json.loads(lines[-1])
    ex = res["extra"]
    for key, want in BENCH_FIRST_POINTS.items():
        require(ex.get(key) == want, f"bench: {key} {ex.get(key)!r}, not the first "
                f"sweep point {want!r}")
    nums = list(_numbers(res))
    require(all(isinstance(x, (int, float)) and not isinstance(x, bool) and x == x
                and 0 < x < float("inf") for x in nums),
            "bench: a value is not a finite positive number")
    require(ex["device"].startswith(torch.cuda.get_device_name(0) + ", ")
            and ex["device"].endswith(" W"), f"bench: device {ex['device']!r}")
    for line in lines[:-1]:
        worker, _, rec = line.partition(": ")
        require(rec.startswith("{"), f"bench: {line[:200]}")
        launches = json.loads(rec)["launches"]
        need = (("thomas_solve",) if worker.startswith("[bench] dycore") else
                tuple(k for k in launches
                      if k not in OPTICS_KERNELS or worker.startswith("[bench] cares")))
        require(all(launches[k] > 0 for k in need), f"bench: {line[:80]}: launches "
                f"{launches}")
    print(f"[bench] {len(nums)} numbers, all finite and positive; first sweep points "
          f"taken; {wall:.1f} s")

    from wrf_partmc_tpu_torch.bench import _build_dycore

    step, state = _build_dycore(*BENCH_DYCORE, device="cuda")
    reset_counts()
    for _ in range(2):
        state = step(state)
    torch.cuda.synchronize()
    launches, shapes = read_counts()
    require(bool(torch.isfinite(state.theta_p).all()), "bench dycore: theta_p not finite")
    n = launches["thomas_solve"]
    require(n > 0, "thomas_solve was not launched on the bench's dycore path")
    kernels["thomas_solve"]["launches_bench_dycore"] = n
    print(f"[launches] bench dycore path {'x'.join(map(str, BENCH_DYCORE))}, 2 steps: "
          f"thomas_solve {n} ({n / 2:g} a step), max |w| {float(state.w.abs().max()):.4f}")
    del step, state
    _free()
    phase_path_shapes("bench dycore path", kernels, shapes)


def phase_draws(kernels: dict):
    """K4's summary over the paths: its launches a step on each, the synced
    draws of each path that ``draw_split`` ran (K4 and the plain version),
    and for each path every draw it made on the card by K4 argument key
    (mode, shape, lo, span, block) with its calls a step and that key's
    device, call, plain and bound times.  Every key a path drew is held
    against the plain draw on the card and on the CPU (here, if no path
    hold reached it)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    print("[draws] K4 launches a step: " + ", ".join(
        f"{path} {launches['threefry_draw'] / steps:g}"
        for path, (launches, steps) in PATH_LAUNCHES.items()))
    for path, res in DRAW_SPLITS.items():
        print(f"[draws] {path}: {split_text(res)}")
    for path, (draws, steps, step_ms) in DRAWS.items():
        late = [k for k in draws if k not in CHECKED["threefry_draw"]]
        for key in sorted(late, key=repr):
            hold(kernels, gen, "threefry_draw", key)
        per = lambda f: sum(c / steps * K4_TIMES[k][f] for k, c in draws.items())
        print(f"[draws] {path}: {sum(draws.values()) / steps:g} draws a step at {len(draws)} "
              f"keys ({len(late)} held here): K4 device {per('ms'):.4f} ms/step, bound "
              f"{per('bound_ms'):.4f}, plain {per('plain_ms'):.4f}, of the path's "
              f"{step_ms:.3f} ms/step")
        for key, calls in sorted(draws.items(), key=repr):
            t, (mode, shape, lo, span, blk) = K4_TIMES[key], key
            print(f"[draws]   {mode} {list(shape)}" + ("" if blk is None else f" block {list(blk)}")
                  + f": {calls / steps:g} a step; device {t['ms']:.4f} ms, call "
                  f"{t['call_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']}), share {t['bound_ms'] / t['ms']:.3f}")
    torch.cuda.empty_cache()


def run_decomposed(kernels: dict):
    """Phases 5, 27, 28, 29 and 31 with their kernel holds (``--decomposed``)."""
    shapes, _ = phase_main_path(kernels)
    _free()
    phase_path_shapes("main path", kernels, shapes)
    phase_card_vs_cpu_decomposed(kernels)
    shapes = phase_decomposed_path(kernels)
    _free()
    phase_path_shapes("decomposed path", kernels, shapes)
    shapes = phase_decomposed_options(kernels)
    _free()
    phase_path_shapes("decomposed option-set and CARES paths", kernels, shapes)
    phase_draws(kernels)


def run_all(kernels: dict):
    """Phases 3-28, 30 and 31."""
    from wrf_partmc_tpu_torch.option_sets import OPTION_SETS

    phase_kernels(kernels)
    phase_card_vs_cpu()
    shapes, captured = phase_main_path(kernels)
    _free()
    phase_path_shapes("main path", kernels, shapes)
    phase_path_indices("main path", captured)
    del captured
    phase_card_vs_cpu_chem()
    model, state, shapes = phase_chem_main_path(kernels)
    phase_chem_split(model, state)
    del model, state
    _free()
    phase_path_shapes("chem-on main path", kernels, shapes)
    shapes = phase_40class(kernels)
    _free()
    phase_path_shapes("40-class path", kernels, shapes)
    phase_card_vs_cpu_cares(kernels)
    shapes, captured = phase_cares_path(kernels)
    _free()
    phase_path_shapes("CARES path", kernels, shapes)
    phase_path_indices("CARES path", captured)
    del captured
    _free()
    phase_diag_card_vs_cpu()
    shapes = phase_cases()
    _free()
    phase_path_shapes("cases", kernels, shapes)
    cs_full, shapes, argv = phase_runner(kernels)
    _free()
    phase_path_shapes("runner path", kernels, shapes)
    phase_resume(cs_full, argv)
    del cs_full
    _free()
    phase_card_vs_cpu_options()
    for name in OPTION_SETS:
        shapes = phase_options_path(kernels, name)
        _free()
        phase_path_shapes(f"{name} options path", kernels, shapes)
    phase_normal_cost()
    phase_card_vs_cpu_files()
    cs_real, shapes = phase_real_path(kernels)
    _free()
    phase_path_shapes("real-data path", kernels, shapes)
    shapes = phase_spec_path(kernels)
    _free()
    phase_path_shapes("spec path", kernels, shapes)
    phase_compact(kernels, cs_real)
    del cs_real
    _free()
    shapes = phase_urban_plume(kernels)
    phase_path_shapes("urban plume", kernels, shapes)
    shutil.rmtree(REAL_DIR, ignore_errors=True)
    phase_card_vs_cpu_linear()
    shapes = phase_linear_path(kernels)
    _free()
    phase_path_shapes("linear path", kernels, shapes)
    phase_card_vs_cpu_decomposed(kernels)
    shapes = phase_decomposed_path(kernels)
    _free()
    phase_path_shapes("decomposed path", kernels, shapes)
    phase_bench(kernels)
    phase_draws(kernels)


def main(argv=None) -> int:
    global T_START
    T_START = t_start = time.perf_counter()
    decomposed_only = (sys.argv[1:] if argv is None else argv) == ["--decomposed"]
    sys.path.insert(0, ROOT)
    try:
        import torch

        import wrf_partmc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable here ({e})", file=sys.stderr)
        return 1
    kernels = {
        "thomas_solve": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/tridiag.cu",
                             replaces="wrf_partmc_tpu/ops/pallas_tridiag.py:33",
                             callers=["ARW acoustic", "vertical diffusion", "MYJ", "Noah",
                                      "linear acoustic", "block ARW acoustic",
                                      "block vertical diffusion", "block MYJ", "block Noah"]),
        "scatter_rows": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/place.cu",
                             replaces="wrf_partmc_tpu/ops/place.py:107",
                             callers=["rebucket", "compact", "rank-local rebucket"]),
        "gather_rows": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/place.cu",
                            replaces="wrf_partmc_tpu/ops/place.py:125",
                            callers=["rebucket", "coagulation", "split_largest",
                                     "rank-local rebucket"]),
        "threefry_draw": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/threefry.cu",
                              replaces="jax.random threefry2x32 (XLA)",
                              callers=["rng.random_bits", "rng.uniform", "rng.normal",
                                       "rng.randint", "rng.gumbel", "rng.categorical",
                                       "coagulation", "transport", "thinning", "dilution",
                                       "deposition", "emission", "inflow",
                                       "sea salt", "block draws"]),
        "mie_fit_bulk": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/mie_fit.cu",
                             replaces="wrf_partmc_tpu/models/partmc/mie.py:255 fit_lookup + "
                                      "optics.py:184 bulk sums (XLA)",
                             callers=["bulk_optical_props", "block CARES"]),
        "move_ranks": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/moves.cu",
                           replaces="wrf_partmc_tpu/models/coupled/transport.py sample_moves, "
                                    "open_boundary_drop and rebucket's class ranks (XLA)",
                           callers=["transport", "block transport"]),
    }
    try:
        phase_card()
        phase_build()
        (run_decomposed if decomposed_only else run_all)(kernels)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"[wall] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [dict(name=k, **v) for k, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
