"""The particle-core leftovers and the 0-D box model of the port against the
JAX package on the CPU: ``aero_state.permute_slots``/``compact`` (K2's
plain version here), ``dist.from_sampled``/``dist_num_density``, the five
coagulation kernels and ``coag_step`` with each, ``deposition.deposit_step``,
one ``box.box_step``, one ``box_model.run_box`` step of the urban plume
with chemistry on (P = 32), and ``tools/urban_plume.build_urban_plume`` at
P = 64 against the repository's ``tools/urban_plume.py``.

The population is fragmented (dead slots between alive ones) over 2x3 cells
with 24 slots.  Both packages draw the same threefry bits through the same
keys (``utils/rng.py``), so alive masks, slot layouts and integer fields
must agree exactly; floats agree to rtol 1e-5 (last-ulp rounding of exp,
log, sqrt and pow between XLA-CPU and torch), slot moves bit for bit, the
dist helpers to rtol 1e-6.  The chemistry step of the box model is held
as tests/test_torch_chem_mosaic.py holds MOSAIC, with the port's float32
subnormals flushed as XLA-CPU flushes the reference's (the tests below say
where that matters)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.config import PartmcConfig as JPartmcConfig
from wrf_partmc_tpu.models.partmc import aero_state as jaero
from wrf_partmc_tpu.models.partmc import box as jbox
from wrf_partmc_tpu.models.partmc import box_model as jbox_model
from wrf_partmc_tpu.models.partmc import coag as jcoag
from wrf_partmc_tpu.models.partmc import deposition as jdep
from wrf_partmc_tpu.models.partmc import dist as jdist
from wrf_partmc_tpu.models.partmc import scenario as jscn
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.env_state import make_env_state

from wrf_partmc_tpu_torch.config import PartmcConfig
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.partmc import aero_state, box, box_model, coag, deposition, dist
from wrf_partmc_tpu_torch.tools import urban_plume

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import urban_plume as jax_urban_plume  # noqa: E402  (the repository's tools/urban_plume.py)
from test_torch_particles import assert_aero_equal, kd  # noqa: E402

CELLS, P = (2, 3), 24
KINDS = ["zero", "constant", "additive", "sedi", "brown"]


def host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def case():
    """A fragmented population (a third of the slots dead, scattered) of
    mixed SO4/OC/BC/NH4 particles from 30 nm to 2 um, with water."""
    ad = jax_make_aero_data()
    r = np.random.default_rng(0)
    vol = np.zeros((*CELLS, ad.n_spec, P), np.float32)
    num = np.zeros((*CELLS, P), np.float32)
    kinds = [("SO4",), ("OC", "BC"), ("SO4", "NH4"), ("OC",)]
    for idx in np.ndindex(CELLS):
        d = np.exp(r.uniform(np.log(3e-8), np.log(2e-6), P))
        for i in range(P):
            kind = kinds[i % len(kinds)]
            w = r.uniform(0.5, 1.5, len(kind))
            for name, wi in zip(kind, w / w.sum()):
                vol[idx][ad.spec_by_name(name), i] = np.pi / 6 * d[i] ** 3 * wi
            vol[idx][ad.i_water, i] = 0.2 * np.pi / 6 * d[i] ** 3 * r.random()
            num[idx][i] = r.uniform(1e6, 1e8)
    dead = r.random((*CELLS, P)) < 0.33
    num = np.where(dead, 0.0, num).astype(np.float32)
    vol = np.where(dead[..., None, :], 0.0, vol).astype(np.float32)
    z = host(jaero.zero_state(ad, P, CELLS))
    src = r.integers(0, 3, (*CELLS, P)).astype(np.int32)
    aero = dataclasses.replace(
        z, vol=vol, num=num, pid=np.where(dead, 0, np.arange(P, dtype=np.int32)),
        source=np.where(dead, 0, src), w_class=np.where(dead, 0, src),
        src_id=np.where(dead[..., None, :], -1, z.src_id).astype(np.int32),
        t_create=r.uniform(0.0, 100.0, (*CELLS, P)).astype(np.float32),
        next_id=np.full(CELLS, P, np.int32))
    aero = dataclasses.replace(
        aero, src_id=aero.src_id.copy(), src_vol=aero.src_vol.copy())
    aero.src_id[..., 0, :] = np.where(dead, -1, src)
    aero.src_vol[..., 0, :] = vol.sum(-2)
    env = dataclasses.replace(
        host(make_env_state(cell_shape=CELLS)),
        temp=r.uniform(275.0, 300.0, CELLS).astype(np.float32),
        pressure=r.uniform(8.5e4, 1.01e5, CELLS).astype(np.float32),
        rel_humid=np.full(CELLS, 0.6, np.float32),
        height=r.uniform(20.0, 80.0, CELLS).astype(np.float32),
        ustar=r.uniform(0.1, 0.6, CELLS).astype(np.float32),
        cell_volume=np.full(CELLS, 2.0, np.float32))
    j = dict(ad=ad, aero=aero, env=env)
    t = {k: from_numpy(v if k != "ad" else host(v)) for k, v in j.items()}
    return j, t


def _jax_aero(j):
    return jax.tree.map(jnp.asarray, j["aero"])


def test_permute_slots(case):
    j, t = case
    r = np.random.default_rng(1)
    dst = np.stack([r.permutation(P) for _ in range(np.prod(CELLS))]).reshape(*CELLS, P)
    dst = np.where(r.random((*CELLS, P)) < 0.2, -1, dst).astype(np.int32)
    ref = host(jax.jit(jaero.permute_slots)(_jax_aero(j), jnp.asarray(dst)))
    out = to_numpy(aero_state.permute_slots(t["aero"], torch.tensor(dst)))
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(out, f.name), getattr(ref, f.name), err_msg=f.name)
    assert 0 < int((out.num > 0).sum()) < int((t["aero"].num > 0).sum())


def test_compact(case):
    j, t = case
    ref = host(jax.jit(jaero.compact)(_jax_aero(j)))
    out = to_numpy(aero_state.compact(t["aero"]))
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(out, f.name), getattr(ref, f.name), err_msg=f.name)
    n = (out.num > 0).sum(-1)
    slot = np.arange(P)
    np.testing.assert_array_equal(out.num > 0, slot < n[..., None])    # alive slots first
    np.testing.assert_array_equal(n, (j["aero"].num > 0).sum(-1))


@pytest.mark.parametrize("vf_shape", ["per_dist", "per_bin"])
def test_from_sampled(case, vf_shape):
    j, _ = case
    S = j["ad"].n_spec
    edges = 1e-6 * np.logspace(np.log10(0.04), 1.0, 9)
    nc = np.array([1e9, 3e9, 2e9, 5e8, 1e8, 1e7, 0.0, 2e6])
    r = np.random.default_rng(2)
    vf = r.random(S) if vf_shape == "per_dist" else r.random((8, S))
    ref = host(jdist.from_sampled(edges, nc, vf, source=2, w_class=1))
    out = to_numpy(dist.from_sampled(edges, nc, vf, source=2, w_class=1))
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f.name)


def test_dist_num_density():
    S = 20
    d = dataclasses.replace(
        jdist.concat_dists([jdist.make_mode(3.2e9, 2e-8, 1.45, np.ones(S)),
                            jdist.make_mode(2.9e9, 1.16e-7, 1.65, np.ones(S))]))
    diam = np.logspace(-9, -5, 200).astype(np.float32).reshape(4, 50)
    ref = np.asarray(jdist.dist_num_density(d, jnp.asarray(diam)))
    out = dist.dist_num_density(from_numpy(host(d)), torch.tensor(diam)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * ref.max())
    assert ref.max() > 1e9


@pytest.mark.parametrize("kind", KINDS)
def test_eval_kernel(case, kind):
    j, t = case
    r = np.random.default_rng(3)
    d1, d2 = (np.exp(r.uniform(np.log(1e-8), np.log(1e-5), (*CELLS, 12))).astype(np.float32)
              for _ in range(2))
    m1, m2 = (1500.0 * np.pi / 6 * d ** 3 for d in (d1, d2))
    ref = np.asarray(jax.jit(lambda *a: jcoag.eval_kernel(kind, *a))(
        d1, d2, m1.astype(np.float32), m2.astype(np.float32), jax.tree.map(jnp.asarray, j["env"])))
    out = coag.eval_kernel(kind, *(torch.tensor(a, dtype=torch.float32)
                                   for a in (d1, d2, m1, m2)), t["env"]).numpy()
    # sedimentation differences two terminal velocities: where they nearly
    # cancel, a last-ulp difference in each is a large relative one, so it
    # gets an absolute floor of 1e-6 of its largest value; the Brownian
    # kernel's Fuchs term differences two cubes, (d + l)^3 - (d^2 + l^2)^1.5,
    # which nearly cancel where l << d: rtol 5e-5
    atol = 1e-6 * float(ref.max()) if kind == "sedi" else 0.0
    np.testing.assert_allclose(out, ref, rtol=5e-5 if kind == "brown" else 1e-5, atol=atol)
    assert (ref == 0).all() if kind == "zero" else (ref > 0).all()


# dt for each kernel that puts the median candidate pair's expected event
# count near 0.3 on this population (the largest pairs take several events)
COAG_DT = {"zero": 60.0, "constant": 1e7, "additive": 1e8, "sedi": 3e9}


@pytest.mark.parametrize("kind", sorted(COAG_DT))
def test_coag_step_kernels(case, kind):
    """``coag_step(kernel=...)`` with each kernel beside Brownian
    (tests/test_torch_particles.py holds the Brownian step)."""
    j, t = case
    key = jax.random.key(5)
    dt = COAG_DT[kind]
    ref = host(jax.jit(lambda a, e: jcoag.coag_step(a, j["ad"], e, dt, key, kernel=kind))(
        _jax_aero(j), jax.tree.map(jnp.asarray, j["env"])))
    out = to_numpy(coag.coag_step(t["aero"], t["ad"], t["env"], dt, kd(key), kernel=kind))
    assert_aero_equal(ref, out)
    merged = int((ref.num > 0).sum()) < int((j["aero"].num > 0).sum()) or \
        not np.array_equal(ref.num.sum(-1), j["aero"].num.sum(-1))
    assert merged == (kind != "zero")


def test_deposit_step(case):
    j, t = case
    key = jax.random.key(7)
    dz = np.random.default_rng(4).uniform(0.5, 2.0, CELLS).astype(np.float32)
    ref = host(jax.jit(lambda a, e: jdep.deposit_step(a, j["ad"], e, 60.0, dz, key))(
        _jax_aero(j), jax.tree.map(jnp.asarray, j["env"])))
    out = to_numpy(deposition.deposit_step(t["aero"], t["ad"], t["env"], 60.0, dz, kd(key)))
    assert_aero_equal(ref, out)
    n0, n1 = int((j["aero"].num > 0).sum()), int((ref.num > 0).sum())
    assert 0 < n1 < n0


def _box_scenario(ad, n_gas):
    """Emission of an OC/BC mode, dilution 1e-4 s-1 toward an SO4 mode."""
    S = ad.n_spec
    vf_e, vf_b = np.zeros(S), np.zeros(S)
    vf_e[ad.spec_by_name("OC")], vf_e[ad.spec_by_name("BC")] = 0.7, 0.3
    vf_b[ad.spec_by_name("SO4")] = 1.0
    return jscn.constant_scenario(
        ad, n_gas, jdist.make_mode(1e3, 5e-8, 1.7, vf_e, source=1, w_class=1),
        gas_emit_rate=np.linspace(1e-4, 1e-3, n_gas), dilution_rate=1e-4,
        back_dist=jdist.make_mode(1e9, 1e-7, 1.6, vf_b), back_gas=np.full(n_gas, 2.0))


def test_box_step(case):
    """One ``box.box_step``: coagulation, gas and aerosol emission and
    dilution, equilibrium water, deposition and the rebalance."""
    j, t = case
    G = 4
    jcfg = JPartmcConfig(num_particles=12, n_emit_slots=4, do_coagulation=True,
                         do_emission=True, do_condensation=True, do_deposition=True)
    cfg = config_from_reference(jcfg, PartmcConfig)
    scn = _box_scenario(j["ad"], G)
    gas = np.random.default_rng(6).uniform(0.0, 5.0, (*CELLS, G)).astype(np.float32)
    dz = np.full(CELLS, 50.0, np.float32)
    key = jax.random.key(9)
    jstate = jbox.BoxState(aero=_jax_aero(j), gas=jnp.asarray(gas), t=jnp.float32(600.0))
    ref = host(jax.jit(lambda b, e: jbox.box_step(b, j["ad"], e, scn, jcfg, 300.0, key,
                                                  dz=dz))(
        jstate, jax.tree.map(jnp.asarray, j["env"])))
    out = box.box_step(box.BoxState(aero=t["aero"], gas=torch.tensor(gas), t=600.0), t["ad"],
                       t["env"], from_numpy(host(scn)), cfg, 300.0, kd(key), dz=dz)
    assert_aero_equal(ref.aero, to_numpy(out.aero))
    np.testing.assert_allclose(out.gas.numpy(), ref.gas, rtol=1e-5)
    assert out.t == float(ref.t) == 900.0


@pytest.fixture(scope="module")
def plume():
    """The urban plume at P = 32 from both tools (the port's on the CPU),
    and the reference's state after its first 300 s step."""
    ref = jax_urban_plume.build_urban_plume(P=32, n_ideal=16)
    out = urban_plume.build_urban_plume(P=32, n_ideal=16, device="cpu")
    a1, g1 = jbox_model.run_box(*ref, t_end=300.0, dt=300.0, n_ideal=16)
    return ref, out, (a1, g1)


class flushed_subnormals:
    """torch's CPU arithmetic with float32 subnormals flushed to zero, as
    XLA-CPU runs the reference."""

    def __enter__(self):
        assert torch.set_flush_denormal(True)

    def __exit__(self, *exc):
        torch.set_flush_denormal(False)


def test_run_box_one_step_chem_on(plume):
    """One 300 s step of ``box_model.run_box`` on the urban plume: emission
    and dilution, coagulation, MOSAIC (CBM-Z, ASTEM, SOA) with water, the
    rebalance.  It starts from the reference's hydrated state after its
    first step: the first step starts from the dry sampled population on
    ASTEM's regime gate, where the reference's own jitted and eager MOSAIC
    differ by 100% in particulate NO3.  The port runs with float32
    subnormals flushed, as XLA-CPU runs the reference (see
    ``test_astem_keeps_subnormal_release``), and is held as
    tests/test_torch_chem_mosaic.py holds MOSAIC: per cell and species the
    represented volume to rtol 5e-3 with a floor of 1e-6 of the cell's total,
    gases to rtol 1e-3 with a floor of 1e-5 of the largest."""
    (_, _, scn, benv, ad, gd, mech), (_, _, t_scn, t_benv, t_ad, t_gd, t_mech), (a1, g1) = plume
    seen = []
    ref_aero, ref_gas = jbox_model.run_box(a1, g1, scn, benv, ad, gd, mech, t_end=300.0,
                                           dt=300.0, n_ideal=16,
                                           observer=lambda *a: seen.append(a[0]))
    with flushed_subnormals():
        out_aero, out_gas = box_model.run_box(
            from_numpy(host(a1)), torch.tensor(np.asarray(g1)), t_scn, t_benv, t_ad, t_gd,
            t_mech, t_end=300.0, dt=300.0, n_ideal=16, observer=lambda *a: seen.append(a[0]))
    assert seen == [300.0, 300.0]
    ref, out = host(ref_aero), to_numpy(out_aero)
    np.testing.assert_array_equal(out.num > 0, ref.num > 0)
    np.testing.assert_allclose(out.num, ref.num, rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(out), sv(ref), rtol=5e-3, atol=1e-6 * sv(ref).sum(-1).max())
    rg = np.asarray(ref_gas)
    np.testing.assert_allclose(out_gas.numpy(), rg, rtol=1e-3, atol=1e-5 * rg.max())
    assert not np.allclose(out_gas.numpy(), np.asarray(g1), rtol=1e-3)


def test_astem_keeps_subnormal_release(plume):
    """The reference's ASTEM releases an acidic particle's NO3 and Cl in
    proportion to release_tot * no3 / (no3 + cl); for ultrafine particles
    that product (~1e-42 mol^2) is a float32 subnormal, which XLA-CPU
    flushes to 0, so the reference releases nothing there.  The port keeps
    the subnormal, as it keeps the DMS+OH rate (ROADMAP §3): from the
    reference's hydrated urban-plume state its float32 ASTEM is within
    1e-4 of its float64 evaluation in NO3 and Cl, and with subnormals
    flushed within 1e-5 of the reference's float32."""
    from wrf_partmc_tpu.models.partmc.cbmz import cbmz_step as jax_cbmz_step
    from wrf_partmc_tpu.models.partmc.mosaic import astem_inorganic as jax_astem

    from wrf_partmc_tpu_torch.models.partmc.mosaic import astem_inorganic
    from wrf_partmc_tpu_torch.utils.tree import tree_map

    (_, _, _, benv, ad, gd, mech), (_, _, _, _, t_ad, t_gd, _), (a1, g1) = plume
    env = jbox_model.make_env_state(benv, 0.0)
    cz = np.float32(benv.cosz(0.0))
    gas = jax.jit(lambda g: jax_cbmz_step(mech, g, env.temp, env.pressure, env.rel_humid, cz,
                                          300.0, n_sub=6))(g1)
    ref = host(jax.jit(lambda a, g: jax_astem(a, g, gd, ad, env, 300.0))(a1, gas)[0])
    args = (from_numpy(host(a1)), torch.tensor(np.asarray(gas)), t_gd, t_ad,
            from_numpy(host(env)), 300.0)
    f64 = lambda x: tree_map(lambda t: t.double() if t.is_floating_point() else t, x)
    kept = to_numpy(astem_inorganic(*args)[0])
    exact = to_numpy(astem_inorganic(*(f64(a) for a in args[:5]), 300.0)[0])
    with flushed_subnormals():
        flushed = to_numpy(astem_inorganic(*args)[0])
    cell = lambda a, s: (a.vol[..., ad.spec_by_name(s), :] * a.num).sum()
    for s in ("NO3", "Cl"):
        np.testing.assert_allclose(cell(kept, s), cell(exact, s), rtol=1e-4, err_msg=s)
        np.testing.assert_allclose(cell(flushed, s), cell(ref, s), rtol=1e-5, err_msg=s)
    # the flush moves NO3 by more than 1%
    assert abs(cell(ref, "NO3") / cell(kept, "NO3") - 1.0) > 0.01


def test_build_urban_plume_matches_tool():
    """The port's scenario at P = 64 against tools/urban_plume.py's: the
    sampled population, the gases, every scenario table and the
    environment functions."""
    aero, gas, scn, benv, *_ = jax_urban_plume.build_urban_plume(P=64, n_ideal=32)
    t_aero, t_gas, t_scn, t_benv, t_ad, t_gd, t_mech = urban_plume.build_urban_plume(
        P=64, n_ideal=32, device="cpu")
    ref, out = host(aero), to_numpy(t_aero)
    np.testing.assert_array_equal(out.num > 0, ref.num > 0)
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f.name)
    np.testing.assert_array_equal(t_gas.numpy(), np.asarray(gas))
    rs, os_ = host(scn), to_numpy(t_scn)
    for name in ("emit_times", "gas_emit_rate", "dilution_rate", "back_gas"):
        np.testing.assert_array_equal(getattr(os_, name), getattr(rs, name), err_msg=name)
    for name in ("emit_dist", "back_dist"):
        for f in dataclasses.fields(getattr(rs, name)):
            a, b = getattr(getattr(os_, name), f.name), getattr(getattr(rs, name), f.name)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f"{name}.{f.name}")
    for t in (0.0, 7200.0, 50000.0):
        for f in ("temp", "rel_humid", "pressure", "height", "cosz"):
            assert getattr(t_benv, f)(t) == getattr(benv, f)(t)
    assert t_mech.n_spec == t_gd.n_spec == 77 and t_ad.n_spec == 20
