"""Time the em_uniform coupled step, undecomposed or on the ranks of a
decomposed world, for strong- and weak-scaling comparisons.

    python wrf_partmc_tpu_torch/tools/scaling.py --nx 40 --ny 40
    python -m wrf_partmc_tpu_torch.parallel.launch -n 4 -- \\
        python wrf_partmc_tpu_torch/tools/scaling.py --nx 80 --ny 80 --split 2

Without a process group (no ``WPMC_COORDINATOR``) it steps
``entry.build(nx, ny, nz, n_part, cap)`` on one device; under the launcher
every rank builds its part of the decomposed model on the ``factor_2d``
mesh (``entry.build(..., mesh=...)``).  Each takes a warm-up step, then
``--steps`` timed steps between two barriers (host clock, the card
synchronized), then with ``--split N`` N steps with the card synchronized
around each section of the coupled step (``SECTIONS``; the halo
exchanges, the other P2P sends and the all-gathers are timed inside the
sections that make them).  Every
rank prints one line ``SCALING {json}``: its ms/step, peak memory, the
collectives a step (``parallel.halo.COUNTS``) and the kernels' launches a
step.  ``--halo-bench N`` (this tree, under the launcher) then times N
halo exchanges of each kind back to back (``halo_bench``).

``--root DIR`` imports the package from another checkout (an earlier
commit unpacked with ``git archive``), so two trees compare in one call:
the script uses only what both have (``entry.build``, the launcher's
environment, ``halo.COUNTS``, the kernels' launch counters, the driver's
section functions, skipping those a tree lacks).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# (module, attribute, label) of the coupled step's sections; a label with
# "/" is timed inside the sections that call it
SECTIONS = (("driver", "partmc_to_wrf", "partmc_to_wrf"), ("driver", "solve_step", "dycore"),
            ("driver", "apply_specified_relax", "wrfbdy blend"),
            ("driver", "vertical_diffusion_state", "vertical diffusion (K1)"),
            ("driver", "make_env", "env"), ("driver", "emission_step", "emission"),
            ("driver", "bulk_optical_props", "optics"),
            ("driver", "microphysics_step", "coagulation macro-step"),
            ("driver", "radiation_driver", "radiation"),
            ("driver", "transport_step", "transport"),
            ("driver", "resample_inflow_particles", "inflow resampling"),
            ("driver", "apply_gas_open_bc", "gas BC"),
            ("driver", "surface_deposition", "deposition"), ("driver", "rebalance", "rebalance"),
            ("driver", "gather_field", "*/all-gather"), ("halo", "pad_axis", "*/halo exchanges"),
            ("halo", "_p2p", "*/P2P"))


def _patch(mods: dict, hook):
    """Wrap each section function found in ``mods`` by ``hook``; returns a
    function that restores them."""
    saved = []
    for mod_name, attr, label in SECTIONS:
        mod = mods[mod_name]
        if not hasattr(mod, attr):
            continue
        inner = getattr(mod, attr)

        def wrapped(*args, _inner=inner, _label=label, **kwargs):
            return hook(_label, _inner, args, kwargs)
        saved.append((mod, attr, inner))
        setattr(mod, attr, wrapped)
    return lambda: [setattr(m, a, f) for m, a, f in saved]


def halo_bench(mesh, calls: int, sync) -> dict:
    """ms a call of the halo exchange and of the collectives it could be
    built from, each ``calls`` times back to back on a block field of the
    main path's 2x2 block ([10, 20, 20]): ``halo.pad_axis`` one- and
    two-sided, its ``batch_isend_irecv`` alone (``halo._p2p``) and the same
    one-sided exchange as one ``all_to_all_single``, both into
    preallocated buffers, one all-reduce of a float, and ``pad_axis``
    between ten small elementwise kernels against those kernels alone."""
    import torch
    import torch.distributed as dist

    from wrf_partmc_tpu_torch.parallel import halo

    x = torch.randn(10, 20, 20, device=mesh.device)
    one = torch.ones(1, device=mesh.device)
    face = x[..., :1].contiguous()
    got = torch.empty_like(face)
    minus = mesh.rank_at(mesh.iy, mesh.ix - 1)
    plus = mesh.rank_at(mesh.iy, mesh.ix + 1)
    ins = [face.numel() if r == minus else 0 for r in range(mesh.size)]
    outs = [face.numel() if r == plus else 0 for r in range(mesh.size)]
    flat_in, flat_out = face.reshape(-1), torch.empty(face.numel(), device=mesh.device)

    def chain():
        y = x
        for _ in range(10):
            y = y * 1.0001 + 0.5
        return y

    def chained_pad():
        y = chain()
        return halo.pad_axis(y, 0, 1, -1, mesh, "x")

    variants = {
        "pad_axis x one-sided": lambda: halo.pad_axis(x, 0, 1, -1, mesh, "x"),
        "pad_axis y two-sided 3": lambda: halo.pad_axis(x, 3, 3, -2, mesh, "y"),
        "batch_isend_irecv bare": lambda: halo._p2p(mesh, [(face, minus, 2)],
                                                    [(got, plus, 2)]),
        "all_to_all_single one-sided": lambda: dist.all_to_all_single(flat_out, flat_in,
                                                                      outs, ins),
        "all_reduce one float": lambda: dist.all_reduce(one),
        "ten elementwise kernels": chain,
        "ten elementwise kernels + pad_axis": chained_pad,
    }
    res = {}
    for label, fn in variants.items():
        fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        res[label] = 1e3 * (time.perf_counter() - t0) / calls
        dist.barrier()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=40)
    ap.add_argument("--ny", type=int, default=40)
    ap.add_argument("--nz", type=int, default=10)
    ap.add_argument("--n-part", type=int, default=1000)
    ap.add_argument("--cap", type=int, default=1280)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--split", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None, help="the checkout to import the package from")
    ap.add_argument("--label", default="")
    ap.add_argument("--halo-bench", type=int, default=0,
                    help="after the steps, time this many halo exchanges of each kind")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)

    import torch

    from wrf_partmc_tpu_torch.entry import build
    from wrf_partmc_tpu_torch.models.coupled import driver
    from wrf_partmc_tpu_torch.ops import place, tridiag
    from wrf_partmc_tpu_torch.parallel import distributed as pdist, halo

    cuda = torch.device(args.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    world = pdist.init_from_env(args.device)
    mesh = pdist.global_mesh() if world else None
    dev = mesh.device if mesh is not None else torch.device(args.device)
    barrier = torch.distributed.barrier if world else (lambda: None)
    kernels = {"thomas_solve": tridiag.thomas_solve, "scatter_rows": place.scatter_rows_cuda,
               "gather_rows": place.gather_rows_cuda}

    t0 = time.perf_counter()
    model, state = build(args.nx, args.ny, args.nz, n_part=args.n_part, cap=args.cap,
                         device=dev, mesh=mesh)
    sync()
    build_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state = model(state)                          # warm-up: step 0 coagulates
    sync()
    halo.reset_counts()
    for fn in kernels.values():
        fn.launches = 0
    barrier()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state = model(state)
    sync()
    barrier()
    dt = time.perf_counter() - t0
    counts = halo.read_counts()
    rep = dict(label=args.label, root=root, nx=args.nx, ny=args.ny, nz=args.nz,
               n_part=args.n_part, cap=args.cap, device=str(dev),
               mesh=list(mesh.shape) if mesh is not None else None,
               rank=mesh.rank if mesh is not None else 0, build_s=build_s,
               steps=args.steps, ms=1e3 * dt / args.steps,
               block=list(state.aero.num.shape), dyn_block=list(state.dyn.theta_p.shape),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
               collectives={k: {f: (v / args.steps if f != "max_bytes" else v)
                                for f, v in rec.items()} for k, rec in counts.items()},
               launches={k: fn.launches / args.steps for k, fn in kernels.items()},
               finite=bool(torch.isfinite(state.dyn.theta_p).all()
                           and torch.isfinite(state.aero.num).all()),
               alive=int(state.aero.n_alive().sum()))
    if args.split:
        acc, calls = {}, {}

        def hook(label, fn, a, kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            acc[label] = acc.get(label, 0.0) + time.perf_counter() - t
            calls[label] = calls.get(label, 0) + 1
            return out
        restore = _patch({"driver": driver, "halo": halo}, hook)
        try:
            barrier()
            t0 = time.perf_counter()
            for _ in range(args.split):
                state = model(state)
            sync()
            total = time.perf_counter() - t0
        finally:
            restore()
        ms = {k: 1e3 * v / args.split for k, v in acc.items()}
        top = sum(v for k, v in ms.items() if "/" not in k)
        rep["split"] = dict(steps=args.split, ms_step=1e3 * total / args.split, sections=ms,
                            rest=1e3 * total / args.split - top,
                            calls={k: v / args.split for k, v in calls.items()})
    if args.halo_bench and world:
        rep["halo_bench_ms"] = halo_bench(mesh, args.halo_bench, sync)
    print("SCALING " + json.dumps(rep), flush=True)
    if world:
        barrier()
        pdist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
