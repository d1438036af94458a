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
   steps (one full coagulation cadence), with every kernel's launch count;
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
    aerosol optics, Noah, chemistry on) on ``cuda`` and on ``cpu``;
11. the CARES path: 72x72x24, 100 particles per cell (capacity 128),
    dt 30 s, chem_dt 300 s: a warm-up step (step 0, chemistry) and 20
    timed steps (two chemistry macro-steps), with every kernel's launch
    count, overall and per caller;
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
    final state bit-equal to the continuous run's.

After each of the paths 5, 7, 9, 11, 13 and 14, every kernel is held against its
plain version at each argument shape that path launched it with and no
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
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


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
    from wrf_partmc_tpu_torch.ops import place, tridiag

    return {"thomas_solve": tridiag.thomas_solve,
            "scatter_rows": place.scatter_rows_cuda,
            "gather_rows": place.gather_rows_cuda}


def reset_counts():
    for fn in _kernel_fns().values():
        fn.launches = 0
        fn.shapes = set()


def read_counts():
    """(launches, argument shapes) of each kernel since ``reset_counts``."""
    fns = _kernel_fns()
    return ({k: fn.launches for k, fn in fns.items()},
            {k: set(fn.shapes) for k, fn in fns.items()})


# the H100 SXM's peaks (NVIDIA's data sheet) for the bounds: device memory
# and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float = 0.0):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``n_bytes`` and do ``n_ops`` float32 operations."""
    t_b = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_o = 1e3 * n_ops / FP32_OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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
    res["bound_ms"], res["bound_by"] = bound(
        4 * (sum(math.prod(s) for s in (dl_s, d_s, du_s)) + 2 * n_f), 9 * n_f)
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


def scatter_bound(x, dst, L2):
    """K2's least traffic for these inputs: the rows with a dst in [0, L2)
    read once, the dst row read once, the whole output written once."""
    C, CH, L1 = x.shape
    moved = int(((dst >= 0) & (dst < L2)).sum())
    return bound(4 * (moved * CH + C * L1 + C * CH * L2)), moved / (C * L1)


def gather_bound(x, src):
    """K3's least traffic for these inputs: each distinct source row read
    once, the src row read once, the whole output written once."""
    import torch

    C, CH, L1 = x.shape
    L2 = src.shape[1]
    valid = (src >= 0) & (src < L1)
    hit = torch.zeros((C, L1 + 1), dtype=torch.bool, device=src.device)
    hit.scatter_(1, torch.where(valid, src, L1).long(), True)
    rows = int(hit[:, :L1].sum())
    return bound(4 * (rows * CH + C * L2 + C * CH * L2)), rows / (C * L1)


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
    (bms, by), share = scatter_bound(x, dst, L2)
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
    (bms, by), share = gather_bound(x, src)
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


CHECKS = {"thomas_solve": check_thomas, "scatter_rows": check_scatter,
          "gather_rows": check_gather}
CHECKED = {k: set() for k in CHECKS}     # argument shapes already held


def hold(kernels: dict, gen, name: str, shapes):
    """Hold kernel ``name`` against its plain version at ``shapes``; the
    kernels line reports the largest error of all its checks."""
    res = CHECKS[name](gen, shapes)
    k = kernels[name]
    k["max_abs_err"] = max(k.get("max_abs_err", 0.0), res["max_abs_err"])
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
    for name, res, main in (("thomas_solve", k1, 1), ("scatter_rows", k2, 0),
                            ("gather_rows", k3, 0)):
        kernels[name].update({k: res[main][k] for k in KEYS})
    torch.cuda.empty_cache()


def phase_path_shapes(label: str, kernels: dict, shapes: dict):
    """Each kernel at every argument shape a path gave it (``read_counts``)
    that no earlier check held, against its plain version."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    new = {k: sorted(v - CHECKED[k], key=repr) for k, v in shapes.items()}
    print(f"[kernels] {label}: shapes launched "
          + json.dumps({k: len(v) for k, v in shapes.items()})
          + ", not yet held " + json.dumps({k: len(v) for k, v in new.items()}))
    for name, todo in new.items():
        for sh in todo:
            hold(kernels, gen, name, sh)
            torch.cuda.empty_cache()


DYN_FIELDS = ("u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem",
              "num_conc", "tke")


def compare_card_cpu(tag: str, out_gpu, out_cpu) -> str:
    """Hold a step on the card against the same step on the CPU: every dycore
    field by the rule of the CPU parity tests against the JAX package
    (tests/test_torch_coupled.py, tests/test_torch_chem_coupled.py): rtol
    1e-4, absolute floor 1e-4 of the field's scale, with roundoff-sized
    floors for w and ph in uniform flow; per cell the represented number rtol
    1e-4 and the per-species volume rtol 1e-4 with a floor of 1e-6 of the
    largest.  Returns the differences as one line."""
    import torch

    floors = {"w": 1e-5, "ph": 1e-3}
    worst = {}
    for name in DYN_FIELDS:
        a, b = getattr(out_gpu.dyn, name), getattr(out_cpu.dyn, name)
        atol = max(floors.get(name, 0.0), 1e-4 * float(b.abs().max()))
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
    require(n_rel <= 1e-4, f"{tag}: per-cell number rel {n_rel}")
    require(torch.allclose(sv_g, sv_c, rtol=1e-4, atol=v_floor),
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


def drive(model, state, n_timed: int):
    """One warm-up step and ``n_timed`` timed steps, the kernels' counts set
    to 0 just before and read just after.  Returns (state, warm-up s, timed
    s, launches, argument shapes)."""
    import torch

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


def require_launched(kernels: dict, key: str, launches: dict, path: str, steps: int):
    """Every kernel launched on the path; its count is printed with its
    launches a step over the ``steps``."""
    for name, rec in kernels.items():
        rec[key] = launches[name]
        require(rec[key] > 0, f"{name} was not launched on the {path}")
    print(f"[launches] {path}, {steps} steps: " + ", ".join(
        f"{name} {rec[key]} ({rec[key] / steps:g} a step)" for name, rec in kernels.items()))


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
    by_caller, captured = {}, {}
    restore = attribute_launches(by_caller, captured)
    state, warm, dt, launches, shapes = drive(model, state, n_timed)
    restore()
    cells = 40 * 40 * 10
    ms = 1e3 * dt / n_timed
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
    state, warm, dt, launches, shapes = drive(model, state, n_timed)
    cells = 40 * 40 * 10
    ms = 1e3 * dt / n_timed
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
    state, warm, dt, launches, shapes = drive(model, state, 1)
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


def phase_card_vs_cpu_cares():
    """One CARES-shaped step (MYJ, Morrison, Grell, correlated-k radiation
    with the aerosol optics, Noah, open boundaries, chemistry on) at
    12x10x8 on the card against the same step on the CPU: the dycore and
    particles by ``compare_card_cpu``, gases as phase 6, the Noah skin and
    soil temperatures and the MYJ q2 by the JAX parity rule of
    tests/test_torch_cares_coupled.py (rtol 1e-5), q2 with an absolute
    floor of 1e-6, 5e-5 of its minimum Q2_MIN = 0.02."""
    import torch

    from wrf_partmc_tpu_torch.cares import build_cares_shape

    model, state = build_cares_shape(12, 10, 8, n_part=16, cap=32, chem_on=True,
                                     device="cpu")
    out_cpu = model(state)                      # step 0 runs the chemistry
    out_gpu = model.to("cuda")(state.to("cuda")).to("cpu")
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
          + " ".join(f"{k} max diff {v:.2e};" for k, v in extra.items()) + f" {line}")


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
    by_caller, captured = {}, {}
    restore = attribute_launches(by_caller, captured)
    state, warm, dt, launches, shapes = drive(model, state, n_timed)
    restore()
    ms = 1e3 * dt / n_timed
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
    require_launched(kernels, "launches_cares", launches, "CARES path", n_timed + 1)
    print(f"[cares] kernel launches by caller: {json.dumps(by_caller)}")
    for caller, n in by_caller.items():
        require(n > 0, f"CARES path: no kernel launch from {caller}")
    return shapes, captured


def attribute_launches(by_caller: dict, captured: dict):
    """Count, per caller, the kernel launches made inside the calls each of
    these modules makes to the kernels' dispatchers: K1 from the MYJ q2
    column and the Noah soil column, K2 and K3 from the transport rebucket,
    K3 from the coagulation pairing.  The first call of K2 or K3 at each
    (caller, shape) also leaves a copy of its index array in ``captured``
    (the path's own dst and src; keyed (kernel, caller, payload shape,
    slots)).  Returns a function that restores the modules."""
    from wrf_partmc_tpu_torch.models.coupled import transport
    from wrf_partmc_tpu_torch.models.partmc import coag
    from wrf_partmc_tpu_torch.models.physics import lsm, myj

    fns = _kernel_fns()
    sites = ((myj, "tridiag_solve", "thomas_solve", "K1 in MYJ"),
             (lsm, "tridiag_solve", "thomas_solve", "K1 in Noah"),
             (transport, "scatter_rows", "scatter_rows", "K2 in the rebucket"),
             (transport, "gather_rows", "gather_rows", "K3 in the rebucket"),
             (coag, "gather_rows", "gather_rows", "K3 in coagulation"))
    saved = []
    for mod, attr, kernel, caller in sites:
        inner = getattr(mod, attr)
        by_caller[caller] = 0

        def counted(*args, _inner=inner, _fn=fns[kernel], _kernel=kernel, _caller=caller):
            if _kernel != "thomas_solve":
                x, idx = args[0], args[1]
                slots = args[2] if _kernel == "scatter_rows" else idx.shape[1]
                key = (_kernel, _caller, tuple(x.shape), slots)
                if key not in captured:
                    captured[key] = idx.clone()
            before = _fn.launches
            out = _inner(*args)
            by_caller[_caller] += _fn.launches - before
            return out
        saved.append((mod, attr, inner))
        setattr(mod, attr, counted)

    def restore():
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)
    return restore


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


RUNNER_NAMELIST = """ &time_control
 history_interval = 1,
 restart          = .false.,
 /
 &domains
 e_we   = 41,
 e_sn   = 41,
 e_vert = 11,
 dx     = 2000.0,
 dy     = 2000.0,
 ztop   = 2000.0,
 /
 &dynamics
 chem_adv_opt  = 2,
 moist_adv_opt = 1,
 diff_opt      = 0,
 km_opt        = 4,
 /
 &partmc
 num_particles    = 1000,
 max_particles    = 1280,
 n_emit_slots     = 4,
 partmc_chem_dt   = 60.0,
 do_coagulation   = .true.,
 do_emission      = .true.,
 do_deposition    = .true.,
 do_transport     = .true.,
 do_mosaic        = .false.,
 record_removals  = .true.,
 record_aero_info = .true.,
 /
 &bdy_control
 periodic_x = .true.,
 periodic_y = .true.,
 /
"""
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


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import torch

        import wrf_partmc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable here ({e})", file=sys.stderr)
        return 1
    kernels = {
        "thomas_solve": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/tridiag.cu",
                             replaces="wrf_partmc_tpu/ops/pallas_tridiag.py:33"),
        "scatter_rows": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/place.cu",
                             replaces="wrf_partmc_tpu/ops/place.py:107"),
        "gather_rows": dict(route="cuda", source="wrf_partmc_tpu_torch/csrc/place.cu",
                            replaces="wrf_partmc_tpu/ops/place.py:125"),
    }
    try:
        phase_card()
        phase_build()
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
        phase_card_vs_cpu_cares()
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
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [dict(name=k, **v) for k, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
