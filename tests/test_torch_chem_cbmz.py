"""CBM-Z gas chemistry of the port against the JAX package under
``jax.jit``, on the same numpy inputs made from a seed.

Tolerances:

* mechanism tables: exact;
* rate coefficients: rtol 2e-5 (last-ulp differences of exp, pow and
  log10 between XLA-CPU and torch);
* Jacobian: per entry, 1e-6 of its row's largest magnitude (entries are
  sums of terms of both signs, summed in another order);
* ``fast_inv``: relative operator error 1e-5 against ``numpy.linalg.inv``
  in float64 (the reference's own inverse sits at ~1e-6);
* ``cbmz_step``: rtol 1e-4 with a 1e-9 ppb floor, DMSO 5e-4 (see below).

The DMS + OH addition channel has the prefactor 1.7e-42, which is subnormal
in float32.  XLA-CPU runs jitted code with subnormals flushed, so the
reference computes this rate as exactly 0 whenever the environment is a
traced input, and as ~2e-12 only when the environment is a compile-time
constant.  The port flushes nothing (neither does CUDA, built without fast
math).  So the cbmz_step comparisons run the reference mechanism with that
one rate function evaluated without the subnormal (1.7e-21 * ... * 1e-21),
and the port's rate, whose float32 prefactor keeps 11 significant bits,
agrees with it to 5e-4.

The inputs are a polluted urban background (the coupled step's, with DMS,
isoprene and aromatics added), in which the reference's Rosenbrock-W step
is well conditioned: a 1e-6 perturbation of its input moves its output by
~4e-6.  Far from equilibrium (tens of ppb of NO and NO2 thrown together at
h = 50 s) the reference amplifies the same perturbation to 20% in O3, and
no parity test can be tighter than that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.models.partmc import cbmz as jcbmz

from wrf_partmc_tpu_torch.models.partmc import cbmz

BACKGROUND = dict(O3=40.0, NO2=10.0, NO=2.0, SO2=5.0, NH3=3.0, HNO3=1.0,
                  HCHO=2.0, CO=150.0, CH4=1800.0, DMS=0.2, ISOP=1.0, PAR=10.0,
                  TOL=1.0, ETH=1.0)


def _dms_add_unflushed(T, M, H2O, J):
    """K_DMS_OH_ADD with its prefactor split so no float32 subnormal forms."""
    o2 = 0.21 * M
    num = 1.7e-21 * jnp.exp(7810.0 / T) * (1e-21 * o2)
    den = 1.0 + 5.5e-31 * jnp.exp(7460.0 / T) * o2
    return num / den


@pytest.fixture(scope="module")
def mechs():
    jm = jcbmz.build_mechanism()
    jm_unflushed = dataclasses.replace(jm, rate_fns=tuple(
        _dms_add_unflushed if f is jcbmz.K_DMS_OH_ADD else f for f in jm.rate_fns))
    i_dms = [i for i, f in enumerate(jm.rate_fns) if f is jcbmz.K_DMS_OH_ADD][0]
    return jm, jm_unflushed, cbmz.build_mechanism(), i_dms


def _env(n, seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(265.0, 310.0, n).astype(np.float32),
            r.uniform(7.0e4, 1.02e5, n).astype(np.float32),
            r.uniform(0.1, 0.95, n).astype(np.float32))


def _background(n, seed=1, spread=0.5):
    r = np.random.default_rng(seed)
    idx = {g: i for i, (g, _) in enumerate(cbmz.CBMZ_GASES)}
    conc = np.zeros((n, 77), np.float32)
    for name, ppb in BACKGROUND.items():
        conc[:, idx[name]] = ppb * r.uniform(1 - spread, 1 + spread, n)
    return conc, idx


@pytest.mark.parametrize("field", ["net", "e1", "e2", "i1", "i2", "has2"])
def test_mechanism_tables(mechs, field):
    jm, _, pm, _ = mechs
    ref, out = np.asarray(getattr(jm, field)), getattr(pm, field).numpy()
    assert out.shape == ref.shape == ((145, 77) if ref.ndim == 2 else (145,))
    np.testing.assert_array_equal(out, ref)
    assert pm.names == jm.names and pm.n_rxn == jm.n_rxn == 145


def test_n_atoms(mechs):
    assert cbmz.N_ATOMS == jcbmz.N_ATOMS


def test_noy_conserved_in_every_reaction(mechs):
    """tests/test_cbmz.py's NOy check on the port's own mechanism: every
    reaction conserves the N atoms of N_ATOMS but those of NH3 + OH (NHx,
    the one sanctioned N sink)."""
    _, _, pm, _ = mechs
    nvec = np.array([cbmz.N_ATOMS.get(n, 0) for n in pm.names], float)
    imbal = pm.net.double().numpy() @ nvec
    bad = np.nonzero(np.abs(imbal) > 1e-5)[0]
    i1, i2, has2 = pm.i1.numpy(), pm.i2.numpy(), pm.has2.numpy()
    allowed = [r for r in bad if pm.names[int(i1[r])] == "NH3"
               or (bool(has2[r]) and pm.names[int(i2[r])] == "NH3")]
    assert list(bad) == allowed, f"NOy-imbalanced reactions: {list(bad)}"
    assert set(cbmz.N_ATOMS) <= set(pm.names)


@pytest.mark.parametrize("cosz", [0.8, -0.2], ids=["day", "night"])
def test_rate_coefficients(mechs, cosz):
    jm, _, pm, i_dms = mechs
    T, P, RH = _env(64)
    mu = np.full(64, cosz, np.float32)
    ref = np.asarray(jax.jit(lambda *a: jcbmz.rate_coefficients(jm, *a))(T, P, RH, mu))
    out = cbmz.rate_coefficients(pm, *map(torch.tensor, (T, P, RH, mu))).numpy()
    keep = np.arange(145) != i_dms
    np.testing.assert_allclose(out[:, keep], ref[:, keep], rtol=2e-5, atol=0)
    assert (out[:, :9] > 0).all() == (cosz > 0)        # the photolysis rows


def test_dms_addition_rate_is_not_flushed(mechs):
    """The jitted reference flushes the subnormal prefactor to 0 with a
    traced environment; the port keeps the rate, which matches the float64
    formula to the 11 bits of the float32 subnormal."""
    jm, _, pm, i_dms = mechs
    T, P, RH = _env(16)
    mu = np.full(16, 0.5, np.float32)
    ref = np.asarray(jax.jit(lambda *a: jcbmz.rate_coefficients(jm, *a))(T, P, RH, mu))
    out = cbmz.rate_coefficients(pm, *map(torch.tensor, (T, P, RH, mu))).numpy()
    assert (ref[:, i_dms] == 0.0).all()
    T64, P64 = T.astype(np.float64), P.astype(np.float64)
    from wrf_partmc_tpu_torch import constants as c
    M = P64 / (c.BOLTZMANN * T64) * 1e-6
    o2 = 0.21 * M
    k = 1.7e-42 * np.exp(7810.0 / T64) * o2 / (1.0 + 5.5e-31 * np.exp(7460.0 / T64) * o2)
    np.testing.assert_allclose(out[:, i_dms], k * M * 1e-9, rtol=5e-4)


@pytest.mark.parametrize("t", [0.0, 3.0e4, 9.0e4])
def test_solar_cos_zenith(t):
    """The driver's float32 solar time and declination formula."""
    from wrf_partmc_tpu.config import uniform_test_config

    from wrf_partmc_tpu_torch.config import DomainConfig
    from wrf_partmc_tpu_torch.convert import config_from_reference

    dom = uniform_test_config().domain
    utc = jnp.float32(dom.gmt * 3600.0) + jnp.float32(t)
    ref = jax.jit(lambda u: jcbmz.cos_zenith(dom.lat0, dom.lon0, dom.julian_day + u // 86400.0,
                                             u % 86400.0))(utc)
    out = cbmz.solar_cos_zenith(config_from_reference(dom, DomainConfig), t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_jacobian(mechs):
    jm, _, pm, i_dms = mechs
    T, P, RH = _env(32)
    conc, _ = _background(32)
    conc += np.random.default_rng(2).uniform(0.0, 1e-3, conc.shape).astype(np.float32)
    k = np.asarray(jax.jit(lambda *a: jcbmz.rate_coefficients(jm, *a))(
        T, P, RH, np.full(32, 0.7, np.float32)))
    ref = np.asarray(jax.jit(lambda c_, k_: jcbmz.jacobian(jm, c_, k_))(conc, k))
    out = cbmz.jacobian(pm, torch.tensor(conc), torch.tensor(k)).numpy()
    assert out.shape == (32, 77, 77)
    tol = 1e-6 * np.abs(ref).max(-1, keepdims=True)
    assert (np.abs(out - ref) <= tol).all()


def _operator(mechs, h):
    jm, _, _, _ = mechs
    T, P, RH = _env(8)
    conc, idx = _background(8)
    conc[1] *= 10.0                      # heavy pollution
    conc[2] *= 0.01                      # clean background
    conc[3, idx["O3"]] = 150.0           # ozone episode
    k = jcbmz.rate_coefficients(jm, T, P, RH, 0.8)
    J = np.asarray(jcbmz.jacobian(jm, jnp.asarray(conc), k))
    return (np.eye(77, dtype=np.float32)
            - np.float32(jcbmz._ROS_GAMMA) * np.float32(h) * J).astype(np.float32)


@pytest.mark.parametrize("h", [10.0, 50.0])
def test_fast_inv_against_numpy(mechs, h):
    A = _operator(mechs, h)
    exact = np.linalg.inv(A.astype(np.float64))
    out = cbmz.fast_inv(torch.tensor(A)).numpy()
    err = np.abs(out - exact).max(axis=(-2, -1)) / np.abs(exact).max(axis=(-2, -1))
    assert (err < 1e-5).all(), err
    ref = np.asarray(jax.jit(jcbmz.fast_inv)(A))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_gj_inv_pivot_ties():
    """Pivot candidates of equal magnitude: both take the first maximum."""
    r = np.random.default_rng(3)
    A = r.integers(-2, 3, (16, 9, 9)).astype(np.float32)
    A += 6.0 * np.eye(9, dtype=np.float32) * (r.random((16, 1, 1)) < 0.5)
    A[np.abs(np.linalg.det(A)) < 1e-3] += 7.0 * np.eye(9, dtype=np.float32)
    ref = np.asarray(jax.jit(jcbmz._gj_inv_small)(A))
    out = cbmz._gj_inv_small(torch.tensor(A)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("dt,cell_block,w_method", [(300.0, 8192, True), (300.0, 5, True),
                                                    (60.0, 8192, True), (60.0, 8192, False)])
def test_cbmz_step(mechs, dt, cell_block, w_method):
    """12 cells with DMS; a cell_block of 5 makes the reference pad its last
    block and the port slice it."""
    _, jm, pm, _ = mechs
    T, P, RH = _env(12, seed=4)
    T = 280.0 + (T - 265.0) * (20.0 / 45.0)          # 280-300 K
    conc, idx = _background(12)
    ref = np.asarray(jax.jit(lambda *a: jcbmz.cbmz_step(
        jm, *a, dt, cell_block=cell_block, w_method=w_method))(conc, T, P, RH, np.float32(0.6)))
    out = cbmz.cbmz_step(pm, torch.tensor(conc), torch.tensor(T), torch.tensor(P),
                         torch.tensor(RH), 0.6, dt, cell_block=cell_block,
                         w_method=w_method).numpy()
    assert np.isfinite(ref).all() and ref[:, idx["DMSO"]].min() > 0
    dmso = idx["DMSO"]
    np.testing.assert_allclose(out[:, dmso], ref[:, dmso], rtol=5e-4, atol=1e-9)
    out[:, dmso] = ref[:, dmso]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-9)
