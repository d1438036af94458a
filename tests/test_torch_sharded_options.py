"""The two physics option sets decomposed at (2, 2) on 4 gloo ranks against
the JAX package's mesh path, block by block, on the CPU.

Each set starts from the JAX package's initial state, as
tests/test_torch_options_coupled.py does (mesoscale 12x12x10 with every
particle's number lifted to 1e-6 of the largest, LES 12x12x8; 16
particles per cell, capacity 32).  The reference is JAX's
``coupled_step(..., mesh=make_mesh(devices[:4], (2, 2)))`` on the
conftest's virtual CPU devices, handed the whole-domain state.  The port's
ranks build the set's whole-domain model (``option_sets.build_option_set``),
cut it and the JAX state to their blocks with ``driver.decompose`` (the
counterpart of handing a whole-domain state to the mesh step) and take one
step; both sets ride one spawn.  Each rank's blocks are held at
tests/test_torch_options_coupled.py's tolerances: dycore fields rtol 1e-4
with a floor of 1e-4 of each field's scale (5e-4 in the LES; the w and ph
roundoff floors); per cell the alive count exact, the represented number
rtol 1e-5 and the per-species volume rtol 1e-4 with a floor of 1e-6 of the
largest; ``source`` and ``w_class`` of alive particles exact (particle for
particle); the slab LSM's skin and deep-soil temperatures rtol 1e-5; sea
salt at level 0 wherever the reference's block has it; the transport
counters, summed over the ranks by the step, rtol 1e-5.

The JAX step hands its transport the probability fields of the port's
ranks: the normalized face probabilities and the vertical operator R that
``transport_step_sharded`` builds from the dycore's outflow probabilities
(``normalized_face_probs``, ``vertical_operator``), each rank's blocks put
together.  The two frameworks compute these fields within round-off of
each other (held at ``PROB_RTOL``/``PROB_ATOL`` against the reference's
own), and a draw that falls between the two values of one threshold moves
its particle one way in one framework and another way in the other.  On
the mesoscale grid one of the 23,616 particles' draws does: at global
cell (k, j, i) = (9, 2, 7), rank 1, the draw u = 0.16305768 lies between
the port's west-face probability 0.16305767 and the reference's
0.163057938, so the particle goes east in the port and west in the
reference; the rebalance then doubles the lone arrival.  Given the same
probabilities, every rank matches the reference particle for particle.

The dycore blocks and the transport probabilities are also held against
the port's own undecomposed step from the same state: bit-equal for the
mesoscale set, so the decomposition computes the probabilities the whole
domain does; for the LES within ``LES_SELF_TOL`` of each field's scale
(measured: 1.35e-4 of p''s, 3.8e-5 of theta''s, 6e-8 in the
probabilities), because at 8 levels ATen orders the ARW column sums by
the tensor's size (tests/test_torch_sharded.py).  The probabilities agree
with the reference's own within 5.8e-7 (mesoscale) and 3.6e-7 (LES).  The
step's collectives are the halo exchanges and one all-reduce (the
transport counters); nothing is gathered.
"""

import concurrent.futures
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_options_coupled import CAP, N_PART, SETS
from test_torch_sharded import RANK_TIMEOUT_S, aero_block, block, ranks_in_background
from wrf_partmc_tpu.models.coupled import transport as jtransport
from wrf_partmc_tpu.models.coupled.driver import coupled_step
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_partmc_tpu.utils import rng as jrng
from wrf_partmc_tpu_torch import option_sets
from wrf_partmc_tpu_torch.convert import from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.coupled import transport
from wrf_partmc_tpu_torch.models.coupled.driver import decompose
from wrf_partmc_tpu_torch.parallel import distributed as pdist
from wrf_partmc_tpu_torch.parallel.launch import free_port

NAMES = sorted(SETS)
DYN = ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem", "num_conc", "tke"]
ATOL = {"w": 1e-5, "ph": 1e-3}
FLOOR = {"mesoscale": 1e-4, "les": 5e-4}
# the LES blocks against the port's undecomposed step, as a share of each
# field's scale (the module docstring: ATen's 8-level column sums) and,
# for the probabilities, absolute
LES_SELF_TOL = 2e-4
# the port's transport probabilities against the reference's own
PROB_RTOL, PROB_ATOL = 1e-4, 1e-6


def _initial(name):
    """(port's whole-domain model, JAX pieces, the JAX initial state, the
    mesoscale particles lifted as ``option_sets.lift_tails`` lifts them)."""
    shape, jax_build = SETS[name]
    model, _ = option_sets.build_option_set(name, *shape, N_PART, CAP, device="cpu")
    jcfg, grid, ad, gd, scn, cs, exch = jax_build(model.cfg)
    if name == "mesoscale":
        num = cs.aero.num
        cs = dataclasses.replace(cs, aero=dataclasses.replace(
            cs.aero, num=jnp.where(num > 0, jnp.maximum(num, 1e-6 * num.max()), 0.0)))
    return model, (jcfg, grid, ad, gd, scn, exch), cs


def _reference(jcfg, grid, ad, gd, scn, exch, mesh):
    """JAX's (2, 2) coupled step whose transport takes the given face
    probabilities and vertical operator; it returns its own as well."""
    def step(cs, ph, R):
        own = {}

        def nfp(*a):
            own["ph"] = nfp0(*a)
            return tuple(ph)

        def vop(*a, **k):
            own["R"] = vop0(*a, **k)
            return R

        jtransport.normalized_face_probs, jtransport.vertical_operator = nfp, vop
        try:
            out = coupled_step(cs, grid, jcfg, ad, gd, scn, exch, jrng.base_key(0),
                               mesh=mesh, diag_out=True)
        finally:
            jtransport.normalized_face_probs, jtransport.vertical_operator = nfp0, vop0
        return out, own

    nfp0, vop0 = jtransport.normalized_face_probs, jtransport.vertical_operator
    return step


@contextlib.contextmanager
def captured_port_transport():
    """Record the port's face probabilities and vertical operator."""
    cap = {}
    nfp, vop = transport.normalized_face_probs, transport.vertical_operator
    transport.normalized_face_probs = lambda *a: cap.setdefault("ph", nfp(*a))
    transport.vertical_operator = lambda *a, **k: cap.setdefault("R", vop(*a, **k))
    try:
        yield cap
    finally:
        transport.normalized_face_probs, transport.vertical_operator = nfp, vop


def whole(blocks, axes):
    """The (2, 2) blocks (numpy, by rank) put together on ``axes``."""
    rows = [np.concatenate(blocks[2 * iy:2 * iy + 2], axis=axes[1]) for iy in range(2)]
    return np.concatenate(rows, axis=axes[0])


def probs_of(cap):
    return ([p.numpy() for p in cap["ph"]], cap["R"].numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (JAX (2, 2) step and its diag, JAX's own probabilities, the
    port's undecomposed step and probabilities, [(rank's step, its
    collectives, its transport counters, its probabilities)]).  The ranks
    run while the test process compiles the references."""
    np_ = lambda x: jax.tree.map(np.asarray, x)
    mesh = jax_make_mesh(jax.devices()[:4], shape=(2, 2))
    init, out, compiled = {}, {}, {}
    with concurrent.futures.ThreadPoolExecutor(len(NAMES)) as pool:
        # each set's XLA compile runs in a thread of its own, beside the
        # next set's build and tracing, the ranks and the port's steps
        for name in NAMES:
            init[name] = model, pieces, cs = _initial(name)
            jcfg, grid = pieces[0], pieces[1]
            C, (nz, ny, nx) = jcfg.n_class, (grid.nz, grid.ny, grid.nx)
            f32 = lambda *sh: jax.ShapeDtypeStruct(sh, jnp.float32)
            compiled[name] = pool.submit(jax.jit(_reference(*pieces, mesh)).lower(
                cs, (f32(C, nz, ny, nx),) * 4, f32(C, ny, nx, nz, nz)).compile)
        task = dict(kind="options", sets={
            name: ((*SETS[name][0], N_PART, CAP), from_numpy(np_(cs)))
            for name, (_, _, cs) in init.items()})
        ranks = ranks_in_background(tmp_path_factory.mktemp("options"), "options", task)
        for name, (model, _, cs) in init.items():
            with captured_port_transport() as cap:
                plain = to_numpy(model(from_numpy(np_(cs))))
            out[name] = (plain, probs_of(cap))
        compiled = {name: c.result() for name, c in compiled.items()}
    outs = [{name: (to_numpy(o[0]), o[1], o[2], probs_of(o[3])) for name, o in r.items()}
            for r in ranks.result()]
    result = {}
    for name, (_, _, cs) in init.items():
        ph = tuple(whole([r[name][3][0][f] for r in outs], (-2, -1)) for f in range(4))
        R = whole([r[name][3][1] for r in outs], (1, 2))
        (ref, jdiag), own = np_(compiled[name](cs, ph, R))
        result[name] = (ref, jdiag, (list(own["ph"]), own["R"]), *out[name], np_(cs),
                        [r[name] for r in outs])
    return result


def yx_block(a, rank):
    return block(a, *divmod(rank, 2), 2, 2, axes=(-2, -1))


@pytest.mark.parametrize("field", DYN)
@pytest.mark.parametrize("name", NAMES)
def test_dycore_on_every_rank(runs, name, field):
    """Each rank's block of the dycore field against the same block of the
    JAX (2, 2) step."""
    ref, *_, outs = runs[name]
    r = getattr(ref.dyn, field)
    atol = max(ATOL.get(field, 0.0), FLOOR[name] * float(np.abs(r).max()))
    for rank, (out, *_) in enumerate(outs):
        o = getattr(out.dyn, field)
        assert o.shape == yx_block(r, rank).shape
        np.testing.assert_allclose(o, yx_block(r, rank), rtol=1e-4, atol=atol,
                                   err_msg=f"{name} rank {rank} {field}")


@pytest.mark.parametrize("name", NAMES)
def test_transport_probabilities(runs, name):
    """The face probabilities and the vertical operator of every rank's
    transport: against the port's undecomposed step bit for bit (the LES:
    within ``LES_SELF_TOL``), and against the reference's own within
    round-off."""
    _, _, (jph, jR), _, (pph, pR), _, outs = runs[name]
    for f, (a, b) in enumerate(zip(jph + [jR], pph + [pR])):
        np.testing.assert_allclose(b, a, rtol=PROB_RTOL, atol=PROB_ATOL, err_msg=f"{name} {f}")
    for rank, (*_, (ph, R)) in enumerate(outs):
        iy, ix = divmod(rank, 2)
        for f, (o, r) in enumerate(zip(ph + [R], [yx_block(p, rank) for p in pph]
                                       + [block(pR, iy, ix, 2, 2, axes=(1, 2))])):
            what = f"{name} rank {rank} field {f}"
            if name == "mesoscale":
                np.testing.assert_array_equal(o, r, err_msg=what)
            else:
                np.testing.assert_allclose(o, r, rtol=0, atol=LES_SELF_TOL, err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_particles_by_block(runs, name):
    """Per cell the alive count exact, the represented number and the
    species volumes; the alive particles' source and weight class slot for
    slot."""
    ref, *_, outs = runs[name]
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    for rank, (out, *_) in enumerate(outs):
        ja, ta = aero_block(ref.aero, *divmod(rank, 2), 2, 2), out.aero
        what = f"{name} rank {rank}"
        np.testing.assert_array_equal((ta.num > 0).sum(-1), (ja.num > 0).sum(-1), err_msg=what)
        np.testing.assert_array_equal(ta.num > 0, ja.num > 0, err_msg=what)
        np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max(),
                                   err_msg=what)
        alive = ja.num > 0
        for f in ("source", "w_class"):
            np.testing.assert_array_equal(np.where(alive, getattr(ta, f), 0),
                                          np.where(alive, getattr(ja, f), 0),
                                          err_msg=f"{what} {f}")
        np.testing.assert_array_equal(ta.next_id, ja.next_id, err_msg=what)
        assert out.step == int(ref.step) == 1


@pytest.mark.parametrize("name", NAMES)
def test_transport_counters(runs, name):
    """Each rank's counters are the whole step's (one all-reduce)."""
    _, jdiag, *_, outs = runs[name]
    assert float(jdiag["movers"]) > 0
    for rank, (_, _, diag, _) in enumerate(outs):
        for k in ("overflow_class", "overflow_free", "movers"):
            np.testing.assert_allclose(float(diag[k]), float(jdiag[k]), rtol=1e-5,
                                       err_msg=f"{name} rank {rank} {k}")


def test_mesoscale_land_and_sea_salt(runs):
    """The slab LSM's temperatures by block, and sea salt at level 0 of
    every rank wherever the reference's block has it."""
    ref, *_, j0, outs = runs["mesoscale"]
    assert np.abs(ref.land.tsk - j0.land.tsk).max() > 1e-3
    i_na = jax_make_aero_data().spec_by_name("Na")
    for rank, (out, *_) in enumerate(outs):
        for f in ("tsk", "t_deep"):
            np.testing.assert_allclose(getattr(out.land, f), yx_block(getattr(ref.land, f), rank),
                                       rtol=1e-5, err_msg=f"rank {rank} {f}")
        ja = aero_block(ref.aero, *divmod(rank, 2), 2, 2)
        salt = lambda a: ((a.vol[0, :, :, i_na, :] > 0) & (a.num[0] > 0)).any(-1)
        assert salt(ja).any()
        np.testing.assert_array_equal(salt(out.aero)[salt(ja)], True, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", NAMES)
def test_blocks_against_undecomposed(runs, name):
    """Each rank's dycore block against the port's undecomposed step from
    the same state, and the step's collectives: no all-gather, one
    all-reduce, the halo exchanges."""
    _, _, _, plain, *_, outs = runs[name]
    for rank, (out, counts, *_) in enumerate(outs):
        for field in DYN:
            o, r = getattr(out.dyn, field), yx_block(getattr(plain.dyn, field), rank)
            what = f"{name} rank {rank} {field}"
            if name == "mesoscale":
                np.testing.assert_array_equal(o, r, err_msg=what)
            else:
                np.testing.assert_allclose(o, r, rtol=0,
                                           atol=LES_SELF_TOL * float(np.abs(r).max()),
                                           err_msg=what)
        assert counts["all_gather"]["calls"] == 0, counts
        assert counts["all_reduce"]["calls"] == 1, counts
        assert counts["p2p"]["calls"] >= counts["halo"]["calls"] > 0, counts


@pytest.mark.parametrize("name", NAMES)
def test_build_option_set_world_of_one(name):
    """``build_option_set(mesh=...)`` in a world of one is the whole build
    (mesoscale: its tails lifted) cut by ``decompose`` to the (1, 1) block."""
    ref_model, ref = option_sets.build_option_set(name, 6, 6, 4, 4, 8, device="cpu")
    if name == "mesoscale":
        ref = option_sets.lift_tails(ref)
    pdist.init(f"127.0.0.1:{free_port()}", 1, 0, "cpu", timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = pdist.global_mesh()
        model, state = option_sets.build_option_set(name, 6, 6, 4, 4, 8, device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="already decomposed"):
            decompose(model, state, mesh)
    finally:
        pdist.shutdown()
    assert model.mesh is mesh and ref_model.mesh is None and model.seed == ref_model.seed
    for a, b in ((state.aero.num, ref.aero.num), (state.aero.vol, ref.aero.vol),
                 (state.dyn.theta_p, ref.dyn.theta_p), (state.dyn.moist, ref.dyn.moist),
                 (state.gas, ref.gas), (model.exch_h, ref_model.exch_h)):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
