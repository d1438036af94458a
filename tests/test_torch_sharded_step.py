"""One decomposed coupled step of the port against the JAX package's mesh
path, block by block, on the CPU.

``entry.build(mesh=...)`` (chemistry off; 8x8x4, 16 particles per cell,
capacity 48; coagulation, emission, deposition and transport on) takes one
step as a world of one in this process (gloo) against
``__graft_entry__._build(mesh=...)`` at (1, 1), and on 4 gloo ranks
against it at (2, 2) on the conftest's virtual CPU devices.  Each rank's
blocks are held against the same block of the JAX result: the dycore
fields (each rank advances only its block) as tests/test_torch_coupled.py
(rtol 1e-4, floor 1e-4 of each field's scale; w and ph roundoff floors),
per cell the alive count exact, the represented number rtol 1e-5, the
per-species volume rtol 1e-4 (floor 1e-6 of the largest), the gases rtol
1e-5.  The dycore blocks are also held bit for bit against the port's
own undecomposed step (the particles draw other streams: a (1, 1) mesh is
not ``mesh=None``, its keys are folded with the block index, in both
packages), and no field is gathered: the step's collectives are the halo
exchanges and the one sum of the transport counters.
"""

import jax
import numpy as np
import pytest

import __graft_entry__ as ge
from test_torch_sharded import RANK_TIMEOUT_S, aero_block, block, ranks_in_background
from wrf_partmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_partmc_tpu_torch.convert import to_numpy
from wrf_partmc_tpu_torch.entry import build
from wrf_partmc_tpu_torch.models.coupled.driver import run_coupled
from wrf_partmc_tpu_torch.parallel import distributed as pdist, halo
from wrf_partmc_tpu_torch.parallel.launch import free_port


def _jax_step(mesh_shape):
    mesh = jax_make_mesh(jax.devices()[:mesh_shape[0] * mesh_shape[1]], shape=mesh_shape)
    fn, cs = ge._build(nx=8, ny=8, nz=4, n_part=16, cap=48, chem_on=False, mesh=mesh)
    return jax.tree.map(np.asarray, jax.jit(fn)(cs))


ATOL = {"w": 1e-5, "ph": 1e-3}
DYN = ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem", "num_conc", "tke"]


def assert_step_block(ref, out, iy, ix, py, px):
    for name in DYN:
        r = block(getattr(ref.dyn, name), iy, ix, py, px, axes=(-2, -1))
        o = getattr(out.dyn, name)
        atol = max(ATOL.get(name, 0.0), 1e-4 * float(np.abs(r).max()))
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=atol, err_msg=name)
    ja, ta = aero_block(ref.aero, iy, ix, py, px), out.aero
    np.testing.assert_array_equal((ta.num > 0).sum(-1), (ja.num > 0).sum(-1))
    np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
    np.testing.assert_allclose(out.gas, block(ref.gas, iy, ix, py, px), rtol=1e-5, atol=1e-6)
    assert out.step == int(ref.step) == 1


@pytest.fixture(scope="module")
def plain():
    """The port's undecomposed step."""
    model, state = build(8, 8, 4, n_part=16, cap=48, device="cpu")
    return to_numpy(model(state))


@pytest.fixture(scope="module")
def world_of_one():
    pdist.init(f"127.0.0.1:{free_port()}", 1, 0, "cpu", timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = pdist.global_mesh()
        model, state = build(8, 8, 4, n_part=16, cap=48, device="cpu", mesh=mesh)
        halo.reset_counts()
        out = to_numpy(model(state))
        return out, halo.read_counts()
    finally:
        pdist.shutdown()


def test_coupled_step_world_of_one(world_of_one, plain):
    """A world of one (gloo, in this process) is the (1, 1) mesh: keys
    folded with (0, 0), the halos local copies."""
    out, counts = world_of_one
    assert_step_block(_jax_step((1, 1)), out, 0, 0, 1, 1)
    # the folded keys make it another draw than the undecomposed step's
    assert not np.array_equal(plain.aero.num, out.aero.num)
    assert counts["halo"]["calls"] > 0 and counts["p2p"]["calls"] == 0
    assert counts["all_gather"]["calls"] == 0


def test_world_of_one_dycore_equals_undecomposed(world_of_one, plain):
    """The 1x1 decomposed dycore is ``mesh=None``'s, bit for bit."""
    out, _ = world_of_one
    for name in DYN:
        np.testing.assert_array_equal(getattr(out.dyn, name), getattr(plain.dyn, name),
                                      err_msg=name)


@pytest.fixture(scope="module")
def stepped_2x2(tmp_path_factory):
    """(each rank's step and collectives, the JAX (2, 2) step computed while
    the ranks step)."""
    outs = ranks_in_background(tmp_path_factory.mktemp("coupled"), "coupled",
                               dict(kind="coupled", args=(8, 8, 4, 16, 48)))
    ref = _jax_step((2, 2))
    return [(to_numpy(out), counts) for out, counts in outs.result()], ref


@pytest.fixture(scope="module")
def ranks_2x2(stepped_2x2):
    return stepped_2x2[0]


def test_coupled_step_2x2(stepped_2x2):
    ranks, ref = stepped_2x2
    for rank, (out, _) in enumerate(ranks):
        assert_step_block(ref, out, *divmod(rank, 2), 2, 2)


def test_coupled_step_2x2_dycore_blocks_equal_undecomposed(ranks_2x2, plain):
    """Each rank's dycore block is the same block of the port's
    undecomposed step, bit for bit, and the periodic step gathers nothing:
    its collectives are the halo exchanges (P2P) and one all-reduce of the
    transport counters."""
    for rank, (out, counts) in enumerate(ranks_2x2):
        for name in DYN:
            np.testing.assert_array_equal(
                getattr(out.dyn, name),
                block(getattr(plain.dyn, name), *divmod(rank, 2), 2, 2, axes=(-2, -1)),
                err_msg=f"rank {rank} {name}")
        assert counts["all_gather"]["calls"] == 0, counts
        assert counts["all_reduce"]["calls"] == 1, counts
        assert counts["p2p"]["calls"] >= counts["halo"]["calls"] > 0, counts


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
