"""One decomposed coupled step of the port against the JAX package's mesh
path, block by block, on the CPU.

``entry.build(mesh=...)`` (chemistry off; 8x8x4, 16 particles per cell,
capacity 48; coagulation, emission, deposition and transport on) takes one
step as a world of one in this process (gloo) against
``__graft_entry__._build(mesh=...)`` at (1, 1), and on 4 gloo ranks
against it at (2, 2) on the conftest's virtual CPU devices.  Each rank's
blocks are held against the same block of the JAX result: dycore fields
(every rank advances the whole domain) as tests/test_torch_coupled.py
(rtol 1e-4, floor 1e-4 of each field's scale; w and ph roundoff floors),
per cell the alive count exact, the represented number rtol 1e-5, the
per-species volume rtol 1e-4 (floor 1e-6 of the largest), the gases rtol
1e-5.  A (1, 1) mesh is not ``mesh=None``: its keys are folded with the
block index, in both packages.
"""

import jax
import numpy as np

import __graft_entry__ as ge
from test_torch_sharded import RANK_TIMEOUT_S, aero_block, block, run_ranks
from wrf_partmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_partmc_tpu_torch.convert import to_numpy
from wrf_partmc_tpu_torch.entry import build
from wrf_partmc_tpu_torch.models.coupled.driver import run_coupled
from wrf_partmc_tpu_torch.parallel import distributed as pdist
from wrf_partmc_tpu_torch.parallel.launch import free_port


def _jax_step(mesh_shape):
    mesh = jax_make_mesh(jax.devices()[:mesh_shape[0] * mesh_shape[1]], shape=mesh_shape)
    fn, cs = ge._build(nx=8, ny=8, nz=4, n_part=16, cap=48, chem_on=False, mesh=mesh)
    return jax.tree.map(np.asarray, jax.jit(fn)(cs))


ATOL = {"w": 1e-5, "ph": 1e-3}
DYN = ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem", "num_conc", "tke"]


def assert_step_block(ref, out, iy, ix, py, px):
    for name in DYN:
        r, o = getattr(ref.dyn, name), getattr(out.dyn, name)
        atol = max(ATOL.get(name, 0.0), 1e-4 * float(np.abs(r).max()))
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=atol, err_msg=name)
    ja, ta = aero_block(ref.aero, iy, ix, py, px), out.aero
    np.testing.assert_array_equal((ta.num > 0).sum(-1), (ja.num > 0).sum(-1))
    np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
    np.testing.assert_allclose(out.gas, block(ref.gas, iy, ix, py, px), rtol=1e-5, atol=1e-6)
    assert out.step == int(ref.step) == 1


def test_coupled_step_world_of_one():
    """A world of one (gloo, in this process) is the (1, 1) mesh: keys
    folded with (0, 0), all-gathers of one block."""
    ref = _jax_step((1, 1))
    pdist.init(f"127.0.0.1:{free_port()}", 1, 0, "cpu", timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = pdist.global_mesh()
        model, state = build(8, 8, 4, n_part=16, cap=48, device="cpu", mesh=mesh)
        out = to_numpy(model(state))
    finally:
        pdist.shutdown()
    assert_step_block(ref, out, 0, 0, 1, 1)
    # the folded keys make it another draw than the undecomposed step's
    plain_model, plain_state = build(8, 8, 4, n_part=16, cap=48, device="cpu")
    plain = to_numpy(plain_model(plain_state))
    assert not np.array_equal(plain.aero.num, out.aero.num)


def test_coupled_step_2x2(tmp_path):
    ref = _jax_step((2, 2))
    outs = run_ranks(tmp_path, "coupled", dict(kind="coupled", args=(8, 8, 4, 16, 48)))
    for rank, out in enumerate(outs):
        assert_step_block(ref, to_numpy(out), *divmod(rank, 2), 2, 2)


def test_run_coupled_threads_the_mesh():
    """``run_coupled`` in a world of one takes the steps ``CoupledModel``
    takes, bit for bit."""
    pdist.init(f"127.0.0.1:{free_port()}", 1, 0, "cpu", timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = pdist.global_mesh()
        assert pdist.process_block(mesh) == ((0, 1), (0, 1))
        model, state = build(6, 6, 4, n_part=4, cap=12, device="cpu", mesh=mesh)
        ref = to_numpy(model(model(state)))
        out = to_numpy(run_coupled(state, model.grid, model.cfg, model.aero_data,
                                   model.gas_data, model.scn, model.exch_h, 2, mesh=mesh))
    finally:
        pdist.shutdown()
    for a, b in ((out.aero.num, ref.aero.num), (out.aero.vol, ref.aero.vol),
                 (out.gas, ref.gas), (out.dyn.theta_p, ref.dyn.theta_p)):
        np.testing.assert_array_equal(a, b)
    assert out.step == ref.step == 2
