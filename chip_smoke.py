#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line and each fatal on failure:

1. the card: its name and power limit (nvidia-smi);
2. build: compile the hand-written CUDA kernels from ``wrf_partmc_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes of the em_uniform main path, with both times;
4. card against CPU: one coupled step at 12x12x4 on ``cuda`` and on ``cpu``
   from the same state;
5. main path: the em_uniform coupled step at 40x40x10 cells, 1000 particles
   per cell (capacity 1280), chemistry off: one warm-up step and six timed
   steps (one full coagulation cadence), with every kernel's launch count.

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
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas {line.strip()}")


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


def phase_kernels(kernels: dict):
    import torch

    from wrf_partmc_tpu_torch.ops import place, tridiag

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # K1: acoustic W'' solve (nz-1 = 9 faces x 1600 columns) and the vdiff
    # solve of the 32 chem tracers ([10, 32, 40, 40] rhs, [10, 1, 40, 40]
    # coefficients read by column modulus)
    k1 = []
    for label, cshape, bshape in (("acoustic", (9, 40, 40), (9, 40, 40)),
                                  ("vdiff", (10, 1, 40, 40), (10, 32, 40, 40))):
        dl, du = rnd(*cshape), rnd(*cshape)
        d = 4.0 + rnd(*cshape).abs()
        b = rnd(*bshape)
        x_k = tridiag.thomas_solve(dl, d, du, b)
        x_p = tridiag.solve_scan(dl, d, du, b)
        torch.cuda.synchronize()
        err = float((x_k - x_p).abs().max())
        rel = err / float(x_p.abs().max())
        ms = cuda_ms(lambda: tridiag.thomas_solve(dl, d, du, b))
        pms = cuda_ms(lambda: tridiag.solve_scan(dl, d, du, b))
        print(f"[kernels] K1 thomas_solve {label} rhs {list(bshape)}: max_abs_err "
              f"{err:.3e} max_rel_err {rel:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms")
        require(rel <= 1e-5, f"K1 {label} disagrees with plain: rel {rel}")
        k1.append((err, ms, pms))
    kernels["thomas_solve"].update(max_abs_err=max(e for e, _, _ in k1),
                                   ms=k1[1][1], plain_ms=k1[1][2])

    # K2/K3 at full width: C = 16000 cells, CH = 33 channels, P = 1280
    C, CH, P, F1, AB = 16000, 33, 1280, 1120, 400
    res = {}
    for label, L1, L2 in (("T1", P, F1), ("T2", AB, AB)):
        x = rnd(C, CH, L1)
        dst = _rand_unique_dst(gen, C, L1, L2, 0.1, dev)
        out_k = place.scatter_rows_cuda(x, dst, L2)
        out_p = place.scatter_rows_plain(x, dst, L2)
        torch.cuda.synchronize()
        require(torch.equal(out_k, out_p), f"K2 scatter {label} not bit-exact")
        err = float((out_k - out_p).abs().max())
        ms = cuda_ms(lambda: place.scatter_rows_cuda(x, dst, L2))
        pms = cuda_ms(lambda: place.scatter_rows_plain(x, dst, L2))
        gbs = 2 * x.numel() * 4 / (ms * 1e-3) / 1e9
        print(f"[kernels] K2 scatter_rows {label} [{C},{CH},{L1}]->{L2}: bit-exact, "
              f"kernel {ms:.4f} ms ({gbs:.0f} GB/s moved) plain {pms:.4f} ms")
        res[("K2", label)] = (ms, pms, err)
        del x, dst, out_k, out_p
    for label, L1 in (("T2", AB), ("coag", P)):
        x = rnd(C, CH, L1)
        src = torch.randint(-1, L1, (C, P), generator=gen, device=dev,
                            dtype=torch.int32)          # -1s and duplicates
        out_k = place.gather_rows_cuda(x, src)
        out_p = place.gather_rows_plain(x, src)
        torch.cuda.synchronize()
        require(torch.equal(out_k, out_p), f"K3 gather {label} not bit-exact")
        err = float((out_k - out_p).abs().max())
        ms = cuda_ms(lambda: place.gather_rows_cuda(x, src))
        pms = cuda_ms(lambda: place.gather_rows_plain(x, src))
        gbs = 2 * out_k.numel() * 4 / (ms * 1e-3) / 1e9
        print(f"[kernels] K3 gather_rows {label} [{C},{CH},{L1}]->{P}: bit-exact, "
              f"kernel {ms:.4f} ms ({gbs:.0f} GB/s moved) plain {pms:.4f} ms")
        res[("K3", label)] = (ms, pms, err)
        del x, src, out_k, out_p
    for name, k, main in (("scatter_rows", "K2", "T1"), ("gather_rows", "K3", "T2")):
        kernels[name].update(
            max_abs_err=max(v[2] for key, v in res.items() if key[0] == k),
            ms=res[(k, main)][0], plain_ms=res[(k, main)][1])
    torch.cuda.empty_cache()


def phase_card_vs_cpu():
    import torch

    from wrf_partmc_tpu_torch.entry import build

    model, state = build(12, 12, 4, n_part=16, cap=48, device="cpu")
    out_cpu = model(state)
    model_gpu = model.to("cuda")
    out_gpu = model_gpu(state.to("cuda")).to("cpu")
    worst = {}
    # dycore: the rule of the CPU parity test against the JAX package
    # (tests/test_torch_coupled.py): rtol 1e-4, absolute floor 1e-4 of the
    # field's scale, with roundoff-sized floors for w and ph in uniform flow
    floors = {"w": 1e-5, "ph": 1e-3}
    for name in ("u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem",
                 "num_conc", "tke"):
        a, b = getattr(out_gpu.dyn, name), getattr(out_cpu.dyn, name)
        atol = max(floors.get(name, 0.0), 1e-4 * float(b.abs().max()))
        worst[name] = float((a - b).abs().max())
        require(torch.allclose(a, b, rtol=1e-4, atol=atol),
                f"card vs CPU: dyn.{name} max diff {worst[name]}")
    num_g, num_c = out_gpu.aero.total_num(), out_cpu.aero.total_num()
    sv_g = torch.sum(out_gpu.aero.vol * out_gpu.aero.num[..., None, :], -1)
    sv_c = torch.sum(out_cpu.aero.vol * out_cpu.aero.num[..., None, :], -1)
    n_rel = float(((num_g - num_c).abs() / num_c.abs().clamp(min=1e-30)).max())
    v_ok = torch.allclose(sv_g, sv_c, rtol=1e-4, atol=1e-6 * float(sv_c.abs().max()))
    v_rel = float(((sv_g - sv_c).abs() / sv_c.abs().clamp(min=1e-30)).max())
    print(f"[card-vs-cpu] 12x12x4, 16/cell: dyn max diffs "
          + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
          + f"; per-cell number max rel {n_rel:.2e}; per-cell species volume "
          f"max rel {v_rel:.2e}; alive {int(out_gpu.aero.n_alive().sum())} vs "
          f"{int(out_cpu.aero.n_alive().sum())}")
    require(n_rel <= 1e-4, f"card vs CPU: per-cell number rel {n_rel}")
    require(v_ok, f"card vs CPU: per-species volume rel {v_rel}")


def phase_main_path(kernels: dict, n_timed: int = 6):
    import torch

    from wrf_partmc_tpu_torch.entry import build
    from wrf_partmc_tpu_torch.ops import place, tridiag

    counters = {"thomas_solve": tridiag.thomas_solve,
                "scatter_rows": place.scatter_rows_cuda,
                "gather_rows": place.gather_rows_cuda}
    t0 = time.perf_counter()
    model, state = build(40, 40, 10, n_part=1000, cap=1280, device="cuda")
    torch.cuda.synchronize()
    print(f"[main] build 40x40x10, 1000/cell, cap 1280: "
          f"{time.perf_counter() - t0:.3f} s, alive {int(state.aero.n_alive().sum())}")
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state = model(state)                       # step 0, with coagulation
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_timed):                   # steps 1..6; step 6 coagulates
        state = model(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
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
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched on the main path")
        kernels[k]["launches"] = n
    return ms


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import torch  # noqa: F401

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
        phase_main_path(kernels)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    import torch

    print(json.dumps({"kernels": [dict(name=k, **v) for k, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
