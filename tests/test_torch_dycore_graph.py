"""The dycore step's CUDA graph (``models/dycore/solve.py``).

On the CPU: which calls are eligible (``graph_key``) and the host
``Grid.ztop`` that lets the damped ARW step run without a device-to-host
read.  On the card (``-m gpu``; skipped without one):

    python -m pytest --noconftest -m gpu tests/test_torch_dycore_graph.py

three coupled steps with the graph (eager, capture, replay) against three
with the dycore forced eager, bit for bit on the em_uniform build (ARW),
the linear core, the CARES physics set and the mesoscale and LES option
sets (``option_sets.OPTION_SETS``); a returned state outliving the
next replay; one capture per grid; and the counts.
"""

import dataclasses

import pytest
import torch

from wrf_partmc_tpu_torch.config import uniform_test_config
from wrf_partmc_tpu_torch.grid import block_grid, make_grid
from wrf_partmc_tpu_torch.models.coupled import driver
from wrf_partmc_tpu_torch.models.dycore import solve
from wrf_partmc_tpu_torch.models.dycore.state import zero_dycore_state
from wrf_partmc_tpu_torch.parallel.mesh import Mesh
from wrf_partmc_tpu_torch.utils.tree import tensor_leaves


def _small_config(nx=8, ny=8, nz=4):
    cfg = uniform_test_config()
    return dataclasses.replace(cfg, domain=dataclasses.replace(cfg.domain, nx=nx, ny=ny, nz=nz))


@pytest.fixture
def counts():
    solve.clear_graphs()
    solve.reset_graph_counts()
    yield solve.GRAPH_COUNTS
    solve.clear_graphs()
    solve.reset_graph_counts()


def test_cpu_state_runs_eagerly(counts):
    cfg = _small_config()
    grid = make_grid(cfg)
    state = zero_dycore_state(cfg, grid)
    assert solve.graph_key(state, grid, cfg) is None
    solve.solve_step(state, grid, cfg)
    solve.solve_step(state, grid, cfg)
    assert solve.read_graph_counts() == {"captures": 0, "replays": 0, "eager": 2}
    assert not solve._GRAPHS


class _CudaLeaf:
    """What ``graph_key`` reads of a leaf, reporting a CUDA device."""

    def __init__(self, t):
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("cuda", 0)
        self.requires_grad = t.requires_grad
        self._stride = t.stride()

    def stride(self):
        return self._stride


def _on_card(state):
    return dataclasses.replace(state, **{
        f.name: _CudaLeaf(getattr(state, f.name)) for f in dataclasses.fields(state)
        if getattr(state, f.name) is not None})


def test_block_grid_is_never_eligible(monkeypatch):
    cfg = _small_config()
    grid = make_grid(cfg)
    on_card = _on_card(zero_dycore_state(cfg, grid))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert solve.graph_key(on_card, grid, cfg) is not None
    block = block_grid(grid, Mesh(shape=(2, 2), rank=0, device=torch.device("cpu")))
    assert solve.graph_key(on_card, block, cfg) is None
    one = block_grid(grid, Mesh(shape=(1, 1), rank=0, device=torch.device("cpu")))
    assert solve.graph_key(on_card, one, cfg) is None


def test_leaf_that_requires_grad_is_never_eligible(monkeypatch):
    cfg = _small_config()
    grid = make_grid(cfg)
    on_card = _on_card(zero_dycore_state(cfg, grid))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert solve.graph_key(on_card, grid, cfg) is not None
    on_card.theta_p.requires_grad = True
    assert solve.graph_key(on_card, grid, cfg) is None


def test_host_ztop_on_an_ideal_grid():
    grid = make_grid(_small_config())
    assert isinstance(grid.ztop, float)
    assert grid.ztop == float(grid.z_full[-1])


def test_host_ztop_on_a_real_data_grid(tmp_path):
    from wrf_partmc_tpu_torch.models.dycore.real import init_real
    from wrf_partmc_tpu_torch.tools.make_inputs import write_wrfinput

    cfg = _small_config(5, 4, 3)
    path = str(tmp_path / "wrfinput.nc")
    write_wrfinput(path, cfg)
    grid, _, _ = init_real(cfg, path)
    assert float(grid.hgt.max()) > 0.0
    assert grid.ztop == float(grid.z_full[-1])


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _build(kind, device):
    from wrf_partmc_tpu_torch.entry import build

    if kind == "em_uniform":
        return build(12, 12, 4, n_part=16, cap=48, everything_on=False, device=device)
    if kind == "linear":
        return build(12, 12, 4, n_part=16, cap=48, dyn_opt="linear", device=device)
    if kind in ("mesoscale", "les"):
        from wrf_partmc_tpu_torch.option_sets import OPTION_SETS, build_option_set

        return build_option_set(kind, *OPTION_SETS[kind].small, 16, 32, device=device)
    from wrf_partmc_tpu_torch.cares import build_cares_shape

    return build_cares_shape(12, 10, 8, n_part=16, cap=32, device=device)


def _steps(model, state, n):
    out = []
    for _ in range(n):
        state = model(state)
        out.append(state)
    return out


def _assert_bit_equal(a, b, what):
    la, lb = tensor_leaves(a, "s"), tensor_leaves(b, "s")
    assert la.keys() == lb.keys(), what
    for name, t in la.items():
        torch.testing.assert_close(t, lb[name], rtol=0.0, atol=0.0, equal_nan=True,
                                   msg=f"{what}: {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["em_uniform", "linear", "cares", "mesoscale", "les"])
def test_captured_steps_match_eager(cuda, counts, kind, monkeypatch):
    model, s0 = _build(kind, cuda)
    if kind == "cares":
        assert model.cfg.dynamics.damp_opt and model.cfg.dynamics.mp_physics == 10
    graphed = _steps(model, s0, 3)
    torch.cuda.synchronize()
    assert solve.read_graph_counts() == {"captures": 1, "replays": 1, "eager": 1}
    monkeypatch.setattr(driver, "solve_step", solve._solve_step_eager)
    eager = _steps(model, s0, 3)
    for n, (g, e) in enumerate(zip(graphed, eager)):
        _assert_bit_equal(g, e, f"{kind} step {n + 1}")


@pytest.mark.gpu
def test_returned_state_outlives_the_next_replay(cuda, counts):
    model, s0 = _build("em_uniform", cuda)
    grid, cfg = model.grid, model.cfg
    s1, _ = solve.solve_step(s0.dyn, grid, cfg)        # eager
    s2, _ = solve.solve_step(s1, grid, cfg)            # captured
    kept = tensor_leaves(s2, "s")
    held = {k: v.clone() for k, v in kept.items()}
    s3, _ = solve.solve_step(s2, grid, cfg)            # replayed
    torch.cuda.synchronize()
    assert solve.read_graph_counts() == {"captures": 1, "replays": 1, "eager": 1}
    entry = next(iter(solve._GRAPHS.values()))
    static = {t.data_ptr() for t in tensor_leaves(entry.static_out, "o").values()}
    for name, t in kept.items():
        assert torch.equal(t, held[name]), name
        assert t.data_ptr() not in static, name
    assert not torch.equal(s3.num_conc, s2.num_conc)


@pytest.mark.gpu
def test_two_grids_of_one_shape_capture_twice(cuda, counts):
    (m1, a), (m2, b) = _build("em_uniform", cuda), _build("em_uniform", cuda)
    outs = {}
    for name, model, state in (("a", m1, a), ("b", m2, b)):
        dyn = state.dyn
        for _ in range(2):
            dyn, _ = solve.solve_step(dyn, model.grid, model.cfg)
        outs[name] = dyn
    torch.cuda.synchronize()
    assert solve.read_graph_counts() == {"captures": 2, "replays": 0, "eager": 2}
    assert len(solve._GRAPHS) == 2
    _assert_bit_equal(outs["a"], outs["b"], "two grids")


@pytest.mark.gpu
def test_counts_eager_then_capture_then_replays(cuda, counts):
    model, state = _build("em_uniform", cuda)
    seen = []
    for _ in range(5):
        state = model(state)
        seen.append(solve.read_graph_counts())
    assert seen[0] == {"captures": 0, "replays": 0, "eager": 1}
    assert seen[1] == {"captures": 1, "replays": 0, "eager": 1}
    assert [c["replays"] for c in seen[2:]] == [1, 2, 3]
    assert seen[-1]["captures"] == 1 and seen[-1]["eager"] == 1
