"""The port's bench (``wrf_partmc_tpu_torch/bench.py``) against the
repository's ``bench.py``.

- The dycore builder against ``bench._build_dycore`` of the JAX package
  at 12x12x8: the initial warm bubble as ``tests/test_torch_dycore.py``
  holds a step (rtol 1e-4, an absolute floor of 1e-4 of each field's
  scale), and the state after 3 steps at rtol 1e-4 with a floor of 1e-3 of
  the field's scale.  The bubble starts from rest, where the pressure
  perturbation is the difference of two totals near 1e5 Pa: the JAX
  package's own float32 run of these 3 steps lies 1.5e-4 (u, w) to 2.7e-4
  (p_p) of each field's scale from the same run in float64, and the port's
  as far; the two float32 runs differ by 0.7e-4 to 3.8e-4.
- The coupled and CARES builders give bit for bit the model and state of
  ``entry.build`` and ``cares.build_cares_shape`` with ``bench.py``'s
  arguments (chem_dt 300 s with chemistry on, else 60 s; ``n_sources``).
- One ``--preset tiny --device cpu`` run, in its own process, started
  when the module starts and read at the end: exit 0, one JSON object on its
  last line with ``bench.py``'s keys (read from its source) less
  ``vs_baseline``, plus each worker's ``_peak_gib`` and ``_window_ms``;
  every number finite and positive, ``extra.device`` the CPU.
- A worker asked for the card on a host without one exits non-zero with
  ``entry.require_device``'s message.
- A failed worker ends the bench with its stderr tail; only a worker that
  ran out of device memory lets a sweep go on to its next point.
"""

import ast
import json
import math
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import bench as jax_bench
from wrf_partmc_tpu_torch import bench
from wrf_partmc_tpu_torch.cares import build_cares_shape
from wrf_partmc_tpu_torch.convert import to_numpy
from wrf_partmc_tpu_torch.entry import build
from wrf_partmc_tpu_torch.ops import tridiag
from wrf_partmc_tpu_torch.utils.tree import tensor_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The tiny preset takes about 30 s alone on 8 cores, and took 297.5 s there
# beside five pytest-xdist workers running the sharded and CARES tests.
TIMEOUT_S = 900


def _start(args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.Popen([sys.executable, "-m", "wrf_partmc_tpu_torch.bench", *args],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, start_new_session=True)
    p.started = time.monotonic()
    return p


def _finish(p):
    """(return code, stdout, stderr); the process group is killed if it
    outlives ``TIMEOUT_S``.  Read once; later calls get the same."""
    if not hasattr(p, "result"):
        timed_out = False
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            out, err = p.communicate()
            timed_out = True
        p.result = (p.returncode, out, err, timed_out)
        p.seconds = time.monotonic() - p.started
    rc, out, err, timed_out = p.result
    if timed_out:
        pytest.fail(f"{p.args} outlived {TIMEOUT_S} s; " + _tails(p))
    return rc, out, err


def _tails(p) -> str:
    _, out, err, _ = p.result
    return (f"return code {p.returncode} after {p.seconds:.1f} s; stdout tail: "
            f"{out[-2000:]}\nstderr tail: {err[-3000:]}")


@pytest.fixture(scope="module", autouse=True)
def runs():
    """The tiny preset and a worker on a missing card, started in the
    background while the builders are compared in this process."""
    procs = {"tiny": _start(["--preset", "tiny", "--device", "cpu"]),
             "no card": _start(["--worker", "dycore", "--nx", "8", "--ny", "8", "--nz", "4",
                                "--steps", "1"])}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()


# ------------------------------------------------------------- (a) dycore

DYN_FIELDS = ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem", "num_conc",
              "tke"]


@pytest.fixture(scope="module")
def dycore():
    run, s0 = jax_bench._build_dycore(12, 12, 8)
    ref = {"initial": jax.tree.map(np.asarray, s0),
           "3 steps": jax.tree.map(np.asarray, jax.jit(lambda s: run(s, 3))(s0))}
    step, s = bench._build_dycore(12, 12, 8, device="cpu")
    ours = {"initial": to_numpy(s)}
    for _ in range(3):
        s = step(s)
    ours["3 steps"] = to_numpy(s)
    return ref, ours


@pytest.mark.parametrize("when", ["initial", "3 steps"])
@pytest.mark.parametrize("name", DYN_FIELDS)
def test_dycore_builder_against_jax(dycore, when, name):
    ref, out = getattr(dycore[0][when], name), getattr(dycore[1][when], name)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.isfinite(out).all()
    scale = float(np.abs(ref).max()) + 1e-30
    floor = 1e-4 if when == "initial" else 1e-3
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=floor * scale)


def test_dycore_bubble_moves(dycore):
    """The warm bubble rises: the dynamics are live over the 3 steps."""
    w = dycore[1]["3 steps"].w
    assert float(np.abs(w).max()) > 1e-3


def test_dycore_k1_plan_at_full_width():
    """K1's launch at the full preset's acoustic solve: [39, 128, 128], 16,384
    columns of 39 levels, through the shared-memory window (n > 32)."""
    a = (39, 128, 128)
    p = tridiag.launch_plan((a,) * 3, (a,), ((128 * 128, 128, 1),))
    assert (p.n, p.bucket, p.window, p.threads) == (39, 0, 39, tridiag.WINDOW_THREADS)
    assert (p.cols, p.blocks) == (16384, 16384 // tridiag.WINDOW_THREADS)
    assert [(f.L, f.b_level, f.columns) for f in p.fields] == [(1, 16384, 16384)]


# ------------------------------------------------- (b) coupled and CARES

def _bench_build(case):
    kind, kw = case
    if kind == "cares":
        return bench._build_cares(12, 10, 8, 16, 32, device="cpu")
    return bench._build_coupled(12, 12, 4, 16, 48, device="cpu", **kw)


def _entry_build(case):
    kind, kw = case
    if kind == "cares":
        return build_cares_shape(12, 10, 8, n_part=16, cap=32, device="cpu")
    chem_on = kw.get("chem_on", False)
    return build(12, 12, 4, n_part=16, cap=48, everything_on=True, chem_on=chem_on,
                 chem_dt=300.0 if chem_on else 60.0, n_sources=kw.get("n_sources"),
                 device="cpu")


CASES = {"chem off": ("coupled", {}), "chem on": ("coupled", {"chem_on": True}),
         "40 classes": ("coupled", {"n_sources": 38}), "cares": ("cares", {})}


def _same_leaves(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_builders_reach_the_entry_points(case):
    (m1, s1), (m2, s2) = _bench_build(CASES[case]), _entry_build(CASES[case])
    assert m1.cfg == m2.cfg
    if case == "chem on":
        assert m1.cfg.partmc.partmc_chem_dt == 300.0
    elif case != "cares":
        assert m1.cfg.partmc.partmc_chem_dt == 60.0
    _same_leaves(dict(m1.named_buffers()), dict(m2.named_buffers()))
    _same_leaves(tensor_leaves(s1, "s"), tensor_leaves(s2, "s"))
    if case == "chem off":              # one step of each, bit for bit
        _same_leaves(tensor_leaves(m1(s1), "s"), tensor_leaves(m2(s2), "s"))


# ------------------------------------------------------ (c) tiny preset

def _reference_keys():
    """(top-level keys, keys under ``extra``) of ``bench.py``'s result, read
    from the dict literals of its ``main``."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    top, extra = set(), set()
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            (top if "metric" in keys else extra).update(keys)
    return top, extra


def _numbers(v):
    if isinstance(v, dict):
        for x in v.values():
            yield from _numbers(x)
    elif isinstance(v, list):
        for x in v:
            yield from _numbers(x)
    elif not isinstance(v, str):
        yield v


WORKER_PREFIXES = ("dycore", "coupled_em_uniform", "coupled_chem_on", "coupled_40class")


def test_tiny_preset(runs):
    rc, out, err = _finish(runs["tiny"])
    assert rc == 0, _tails(runs["tiny"])
    res = json.loads(out.strip().splitlines()[-1])
    top, extra = _reference_keys()
    assert "vs_baseline" in top and "cares_shape_grid" in extra
    assert set(res) == top - {"vs_baseline"}
    added = {f"{p}_{k}" for p in WORKER_PREFIXES for k in ("peak_gib", "window_ms")}
    # the tiny preset runs no CARES point, as in bench.py
    assert set(res["extra"]) == {k for k in extra if not k.startswith("cares_shape")} | added
    assert res["metric"].startswith("solve_em grid-points/s/chip (32x32x8")
    assert res["unit"] == "grid-points/s" and res["extra"]["device"] == "cpu"
    assert res["extra"]["coupled_num_particles_per_cell"] == 32
    assert res["extra"]["coupled_chem_on_particles_per_cell"] == 32
    assert res["extra"]["coupled_40class_particles_per_cell"] == 32
    for p in WORKER_PREFIXES:
        assert len(res["extra"][f"{p}_window_ms"]) == 3
        assert set(res["extra"][f"{p}_peak_gib"]) == {"build", "steps"}
    nums = list(_numbers(res))
    assert nums and all(isinstance(x, (int, float)) and not isinstance(x, bool)
                        and math.isfinite(x) and x > 0 for x in nums), res


def test_tiny_preset_progress_lines(runs):
    """Every worker's own result is printed on an earlier line, and the CPU
    launches no kernel."""
    rc, out, _ = _finish(runs["tiny"])
    lines = [ln for ln in out.splitlines() if ln.startswith("[bench] ")]
    assert rc == 0 and len(lines) == 4, _tails(runs["tiny"])
    for ln in lines:
        rec = json.loads(ln.split(": ", 1)[1])
        assert rec["launches"] == {"thomas_solve": 0, "scatter_rows": 0, "gather_rows": 0,
                                   "threefry_draw": 0, "mie_fit_bulk": 0}


# --------------------------------------------------------- (d) no card

def test_worker_without_a_card_raises(runs):
    if torch.cuda.is_available():
        p = runs["no card"]
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.skip("a CUDA device is present: the worker runs on it")
    rc, out, err = _finish(runs["no card"])
    assert rc != 0
    assert "no CUDA device is available" in err
    assert not any(ln.startswith("{") for ln in out.splitlines())


def test_bench_imports_no_reference():
    """The port's bench imports neither JAX, the JAX package, the root
    ``bench.py`` nor ``__graft_entry__``."""
    tree = ast.parse(open(bench.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "wrf_partmc_tpu", "bench", "__graft_entry__"}


def test_spawn_reports_a_failed_worker():
    """A worker that fails other than by running out of memory raises, with
    its return code and stderr tail in the message."""
    with pytest.raises(bench.WorkerFailed) as e:
        bench._spawn("dycore", ["--nx", "nine"], "cpu")
    assert str(e.value).startswith("[bench] dycore --nx nine: failed, return code 2; "
                                   "stderr: ")
    assert "invalid int value: 'nine'" in str(e.value)


def _fake_run(stderr: str, calls: list):
    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", stderr)
    return run


@pytest.mark.parametrize("mark", bench.OOM_MARKS)
def test_spawn_out_of_memory_gives_none(monkeypatch, capsys, mark):
    """Only a worker whose stderr names running out of device memory gives
    None (a sweep's cue to try its next point), its tail printed."""
    calls = []
    monkeypatch.setattr(bench.subprocess, "run", _fake_run(f"torch {mark}: 2 GiB", calls))
    assert bench._spawn("coupled", ["--nx", "40"], "cuda") is None
    assert calls and "failed, return code 1" in capsys.readouterr().out


def test_main_exits_nonzero_on_a_failed_worker(monkeypatch, capsys):
    """A failing worker ends the whole run with exit 1 and its stderr tail,
    and no result line: the sweep does not go on past it."""
    calls = []
    monkeypatch.setattr(bench.subprocess, "run",
                        _fake_run("Traceback ...\nValueError: broken step", calls))
    assert bench.main(["--preset", "tiny", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert len(calls) == 1 and "--worker" in calls[0] and "dycore" in calls[0]
    assert "ValueError: broken step" in err and not out.strip()


def test_preset_follows_device(monkeypatch):
    """``--preset tiny`` hands its workers ``--device``, which defaults to
    the card."""
    calls = []
    monkeypatch.setattr(bench.subprocess, "run", _fake_run("ValueError", calls))
    bench.main(["--preset", "tiny"])
    bench.main(["--preset", "tiny", "--device", "cpu"])
    assert [c[c.index("--device") + 1] for c in calls] == ["cuda", "cpu"]


def test_time_run_median_and_windows():
    """One warm-up window, then three, the state carried through all and
    the median reported."""
    calls = []

    def build():
        return (lambda s: calls.append(s) or s + 1), 0

    t, times, state, rep = bench._time_run(build, 2, "cpu")
    assert state == 8 and calls == list(range(8))
    assert len(times) == 3 and t == sorted(times)[1]
    assert rep["peak_gib"]["build"] > 0 and rep["peak_gib"]["steps"] >= rep["peak_gib"]["build"]
