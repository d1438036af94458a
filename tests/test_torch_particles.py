"""Particle processes of the port against the JAX package on one converted
state and one key: coagulation, transport, rebalance and add_particles.

The state is the em_uniform initial population of ``__graft_entry__._build``
at 12x12x4 with 16 particles per cell (capacity 48).  Both sides draw the
same threefry bits; the physics differ only in last-ulp rounding, so alive
masks, slot layouts and integer fields must agree exactly and float fields
to rtol 1e-5.  Dead slots are compared only by ``num == 0`` (the JAX
add_particles branches themselves fill them differently), but for
add_particles with E > 64, whose every slot, dead or alive, is compared.
"""

import dataclasses

import jax
import numpy as np
import pytest

from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.coupled import driver as jdriver
from wrf_partmc_tpu.models.coupled.transport import transport_step as jax_transport_step
from wrf_partmc_tpu.models.dycore.solve import solve_step as jax_solve_step
from wrf_partmc_tpu.models.partmc import aero_state as jaero
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.coag import coag_step as jax_coag_step
from wrf_partmc_tpu.models.physics.pbl import k_profile_exch_h as jax_exch

import __graft_entry__ as ge
from wrf_partmc_tpu_torch.convert import from_numpy, to_numpy
from wrf_partmc_tpu_torch.entry import make_config
from wrf_partmc_tpu_torch.models.coupled.transport import transport_step
from wrf_partmc_tpu_torch.models.partmc import aero_state
from wrf_partmc_tpu_torch.models.partmc.coag import coag_step

INT_FIELDS = ("pid", "source", "w_class", "hyst_leg")


def kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def assert_aero_equal(ref, out, rtol=1e-5):
    """Alive masks and integer fields exact, floats to rtol, dead slots by
    num == 0 only."""
    alive = ref.num > 0
    np.testing.assert_array_equal(out.num > 0, alive)
    np.testing.assert_allclose(out.num, ref.num, rtol=rtol, atol=0)
    np.testing.assert_array_equal(out.next_id, ref.next_id)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(np.where(alive, getattr(out, name), 0),
                                      np.where(alive, getattr(ref, name), 0), err_msg=name)
    np.testing.assert_array_equal(np.where(alive[..., None, :], out.src_id, 0),
                                  np.where(alive[..., None, :], ref.src_id, 0))
    for name in ("vol", "src_vol"):
        a, b = getattr(out, name), getattr(ref, name)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6 * np.abs(b).max(), err_msg=name)
    np.testing.assert_allclose(np.where(alive, out.t_create, 0),
                               np.where(alive, ref.t_create, 0), rtol=1e-6)


@pytest.fixture(scope="module")
def setup():
    cfg = make_config(12, 12, 4, 16, 48).replace(n_class=8)
    _, cs = ge._build(nx=12, ny=12, nz=4, n_part=16, cap=48, chem_on=False)
    grid = jax_make_grid(cfg)
    ad = jax_make_aero_data()
    dyn = jdriver.partmc_to_wrf(cs, grid, cfg)
    dyn2, diag = jax.jit(lambda d: jax_solve_step(d, grid, cfg))(dyn)
    env = jdriver.make_env(dyn2, grid, cfg, cs.step)
    vol3 = jdriver.cell_volume_3d(dyn2, grid)
    rho3 = jdriver.cell_air_mass(dyn2, grid) / vol3
    dz3 = vol3 / (grid.dx * grid.dy)
    exch = jax_exch(grid, 0.4, 800.0)
    j = dict(cfg=cfg, grid=grid, ad=ad, aero=cs.aero, env=env, diag=diag,
             rho3=rho3, dz3=dz3, exch=exch)
    t = {k: from_numpy(jax.tree.map(np.asarray, v)) for k, v in j.items() if k != "cfg"}
    return j, t


def test_coag_step(setup):
    j, t = setup
    key = jax.random.fold_in(jax.random.key(0), 1)
    ref = jax.jit(lambda a, e, k: jax_coag_step(a, j["ad"], e, 60.0, k))(
        j["aero"], j["env"], key)
    out = coag_step(t["aero"], t["ad"], t["env"], 60.0, kd(key))
    ref = jax.tree.map(np.asarray, ref)
    assert np.sum(ref.num > 0) < np.sum(np.asarray(j["aero"].num) > 0)  # events happened
    assert_aero_equal(ref, to_numpy(out))


def test_transport_step(setup):
    j, t = setup
    cfg = j["cfg"]
    key = jax.random.fold_in(jax.random.key(0), 3)
    ref, rdiag = jax.jit(lambda a, k: jax_transport_step(
        a, j["diag"].probs, j["diag"].xkhh, j["exch"], j["grid"], cfg, cfg.dynamics.dt, k,
        return_diag=True, rho3=j["rho3"], dz3=j["dz3"]))(j["aero"], key)
    out, diag = transport_step(t["aero"], t["diag"].probs, t["diag"].xkhh, t["exch"],
                               t["grid"], cfg, cfg.dynamics.dt, kd(key),
                               rho3=t["rho3"], dz3=t["dz3"])
    for k in ("overflow_class", "overflow_free", "movers"):
        assert float(diag[k]) == float(rdiag[k]), k
    assert float(diag["movers"]) > 0
    assert_aero_equal(jax.tree.map(np.asarray, ref), to_numpy(out))


def _thinned(aero, keep_per_cell):
    """aero (numpy) with only the first ``keep_per_cell`` slots of every
    other column alive."""
    num = np.array(aero.num)
    cols = (np.arange(num.shape[2])[None, None, :, None] % 2) == 0
    num = np.where(cols & (np.arange(num.shape[-1]) >= keep_per_cell), 0.0, num)
    vol = np.where(num[..., None, :] > 0, aero.vol, 0.0).astype(np.float32)
    return dataclasses.replace(aero, num=num.astype(np.float32), vol=vol)


@pytest.mark.parametrize("case,n_ideal", [("halving", 8), ("doubling", 16)])
def test_rebalance(setup, case, n_ideal):
    j, _ = setup
    base = jax.tree.map(np.asarray, j["aero"])
    if case == "doubling":
        base = _thinned(base, 3)            # 3 < 16 // 2 alive: split_largest
    key = jax.random.fold_in(jax.random.key(0), 5)
    ref = jax.tree.map(np.asarray, jaero.rebalance(jax.tree.map(jax.numpy.asarray, base),
                                                   key, n_ideal))
    out = aero_state.rebalance(from_numpy(base), kd(key), n_ideal)
    assert np.sum(ref.num > 0) != np.sum(base.num > 0)
    assert_aero_equal(ref, to_numpy(out))


def assert_every_slot_equal(ref, out):
    """Every field of every slot, dead slots included: integers exact,
    floats to rtol 1e-6."""
    for name in ("pid", "source", "w_class", "hyst_leg", "src_id", "next_id"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name), err_msg=name)
    for name in ("num", "vol", "src_vol", "t_create"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name), rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("E", [4, 65, 100])
def test_add_particles(E):
    """E=4 is the emission path; E=65 and E=100 take the JAX package's
    large-E branch (2x2x1 cells, capacity 160), including one cell that
    overflows.  That branch places only live entries, so there every field
    of every slot is compared, dead slots included."""
    r = np.random.default_rng(E)
    ad = jax_make_aero_data()
    S, P, cs = 20, 160, (1, 2, 2)
    n0 = np.array([[[10, 80], [0, 150]]])
    num = np.zeros((*cs, P), np.float32)
    for idx in np.ndindex(cs):
        slots = r.permutation(P)[:n0[idx]]      # fragmented population
        num[idx][slots] = r.uniform(1e3, 1e4, len(slots))
    vol = (r.uniform(1e-24, 1e-22, (*cs, S, P)) * (num[..., None, :] > 0)).astype(np.float32)
    st = dataclasses.replace(
        jax.tree.map(np.asarray, jaero.zero_state(ad, P, cs)), num=num, vol=vol,
        pid=np.where(num > 0, np.arange(P), 0).astype(np.int32),
        next_id=np.full(cs, P, np.int32))
    new_num = r.uniform(1e3, 1e4, (*cs, E)).astype(np.float32)
    new_num[r.random((*cs, E)) < 0.1] = 0.0      # dead entries
    new_vol = r.uniform(1e-24, 1e-22, (*cs, S, E)).astype(np.float32)
    new_src = r.integers(0, 7, (*cs, E)).astype(np.int32)
    new_wcl = r.integers(0, 8, (*cs, E)).astype(np.int32)
    ref = jaero.add_particles(jax.tree.map(jax.numpy.asarray, st), new_vol, new_num,
                              new_src, new_wcl, time=30.0)
    out = aero_state.add_particles(from_numpy(st), *map(from_numpy, (new_vol, new_num,
                                                                      new_src, new_wcl)),
                                   time=30.0)
    ref, out = jax.tree.map(np.asarray, ref), to_numpy(out)
    assert_aero_equal(ref, out, rtol=1e-6)
    if E > 64:
        assert_every_slot_equal(ref, out)
