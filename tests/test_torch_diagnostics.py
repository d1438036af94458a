"""The port's diagnostics (``models/partmc/{bin_grid,diagnostics}.py``)
against the JAX package's on one population made from a seed: 2x3x4
cells, 24 slots, 4 of them dead in every cell, one cell empty, particle
dry diameters 30 nm to 3 um, so the submicron and PM cuts split the
population.  Every particle has a solute kappa of at least 0.1, where the
reference's float32 critical supersaturation is well conditioned
(tests/test_torch_chem_micro.py).  All the JAX outputs come from one
``jax.jit``.

The port bins by ``scatter_add_`` and gathers by index where the reference
contracts one-hot arrays, so sums run in another order.  The bin edges
are 10**x of float32 exponents, where one ulp of x is about 1e-6 of the
edge, so they are held to rtol 1e-5; every binned and bulk sum, PM, CCN and the
diversities and chi to rtol 1e-5, and the optical coefficients (the Mie
table, ``log10``) to rtol 1e-4.  Every diagnostic past the edges is
computed on the reference's bin grid, so no particle changes bin.  NaN
must stand where the reference has NaN: an empty cell has a NaN D_alpha,
D_gamma 1 and chi 1.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.models.partmc import aero_state as jaero
from wrf_partmc_tpu.models.partmc import bin_grid as jbin
from wrf_partmc_tpu.models.partmc import diagnostics as jdiag
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.env_state import make_env_state
from wrf_partmc_tpu_torch.convert import from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.partmc import bin_grid, diagnostics

CELLS, P, DEAD = (2, 3, 4), 24, 4
EMPTY = (1, 2, 3)
KINDS = [("SO4",), ("SO4", "NH4"), ("NH4", "NO3"), ("Na", "Cl"), ("SO4", "OC"),
         ("SO4", "BC", "OC"), ("SO4", "NH4", "NO3", "OIN")]
GROUPS = {"inorganic": ("SO4", "NO3", "NH4", "Na", "Cl"), "carbon": ("OC", "BC"),
          "other": ("OIN",)}


def _population(ad, r):
    vol = np.zeros((*CELLS, ad.n_spec, P), np.float32)
    num = np.zeros((*CELLS, P), np.float32)
    for idx in np.ndindex(CELLS):
        if idx == EMPTY:
            continue
        d = np.exp(r.uniform(np.log(3e-8), np.log(3e-6), P))
        for i in range(P - DEAD):
            kind = KINDS[r.integers(len(KINDS))]
            w = r.uniform(0.5, 1.5, len(kind))
            if "SO4" in kind:                     # keeps kappa >= 0.1
                w[kind.index("SO4")] += w.sum()
            v = np.pi / 6 * d[i] ** 3
            for name, wi in zip(kind, w / w.sum()):
                vol[idx][ad.spec_by_name(name), i] = v * wi
            vol[idx][ad.i_water, i] = 0.3 * v * r.random()
            num[idx][i] = r.uniform(1e6, 1e8)
    return vol, num


@pytest.fixture(scope="module")
def case():
    ad = jax_make_aero_data()
    r = np.random.default_rng(0)
    vol, num = _population(ad, r)
    perm = r.permuted(np.tile(np.arange(P), (*CELLS, 1)), axis=-1)   # dead slots anywhere
    vol = np.take_along_axis(vol, perm[..., None, :], -1)
    num = np.take_along_axis(num, perm, -1)
    aero = dataclasses.replace(jax.tree.map(np.asarray, jaero.zero_state(ad, P, CELLS)),
                               vol=vol, num=num)
    env = dataclasses.replace(
        jax.tree.map(np.asarray, make_env_state(cell_shape=CELLS)),
        temp=r.uniform(275.0, 300.0, CELLS).astype(np.float32),
        pressure=r.uniform(8.5e4, 1.01e5, CELLS).astype(np.float32),
        rel_humid=r.uniform(0.3, 0.9, CELLS).astype(np.float32),
        cell_volume=r.uniform(1.0, 3.0, CELLS).astype(np.float32))
    gm = np.zeros((len(GROUPS), ad.n_spec), np.float32)
    for g, names in enumerate(GROUPS.values()):
        for name in names:
            gm[g, ad.spec_by_name(name)] = 1.0
    pmask = (r.random((*CELLS, P)) < 0.6).astype(np.float32)
    bg = jbin.make_bin_grid(40, 1e-8, 1e-5)

    def ref_fn(a, e):
        d = a.dry_diameter(ad)
        return dict(
            idx=jbin.bin_index(bg, d), hist=jbin.histogram(bg, d, a.num),
            msm=jdiag.mixing_state_metrics(a, ad),
            msm_groups=jdiag.mixing_state_metrics(a, ad, group_masks=gm),
            msm_mask=jdiag.mixing_state_metrics(a, ad, particle_mask=pmask),
            pm=jdiag.pm_mass(a, ad, 1e-6, e.cell_volume),
            avg=jdiag.bin_average_comp(a, ad, bg).vol,
            advanced=jdiag.process(a, ad, e, bg, advanced=True),
            basic=jdiag.process(a, ad, e, bg, advanced=False))

    ref = jax.tree.map(np.asarray, jax.jit(ref_fn)(aero, env))
    port = dict(ad=from_numpy(jax.tree.map(np.asarray, ad)), aero=from_numpy(aero),
                env=from_numpy(env), bg=from_numpy(jax.tree.map(np.asarray, bg)),
                gm=torch.tensor(gm), pmask=torch.tensor(pmask))
    return ref, port, jax.tree.map(np.asarray, bg)


def test_make_bin_grid(case):
    _, _, jbg = case
    bg = bin_grid.make_bin_grid(40, 1e-8, 1e-5)
    assert bg.n_bin == jbg.n_bin == 40
    np.testing.assert_allclose(bg.edges.numpy(), jbg.edges, rtol=1e-5)
    np.testing.assert_allclose(bg.centers.numpy(), jbg.centers, rtol=1e-5)
    np.testing.assert_allclose(float(bg.log_width), np.log(jbg.edges[1] / jbg.edges[0]),
                               rtol=1e-6)


def test_bin_index_and_histogram(case):
    ref, t, _ = case
    d = t["aero"].dry_diameter(t["ad"])
    idx = bin_grid.bin_index(t["bg"], d)
    np.testing.assert_array_equal(idx.numpy(), ref["idx"])
    assert idx.min() == 0 and idx.max() > 20       # dead slots (d = 0) in bin 0
    hist = bin_grid.histogram(t["bg"], d, t["aero"].num).numpy()
    np.testing.assert_allclose(hist, ref["hist"], rtol=1e-5)
    np.testing.assert_allclose(hist.sum(-1), t["aero"].num.sum(-1).numpy(), rtol=1e-5)


def test_bin_index_out_of_range_and_nan(case):
    _, t, _ = case
    d = torch.tensor([0.0, 1e-12, float("nan"), 1.0, float("inf")])
    assert bin_grid.bin_index(t["bg"], d).tolist() == [0, 0, 0, 39, 39]


def _close(out, ref, rtol, what):
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=0.0, equal_nan=True, err_msg=what)


@pytest.mark.parametrize("variant", ["msm", "msm_groups", "msm_mask"])
def test_mixing_state_metrics(case, variant):
    ref, t, _ = case
    kw = dict(msm={}, msm_groups=dict(group_masks=t["gm"]),
              msm_mask=dict(particle_mask=t["pmask"]))[variant]
    out = diagnostics.mixing_state_metrics(t["aero"], t["ad"], **kw)
    for name, o, r in zip(("chi", "d_alpha", "d_gamma"), out, ref[variant]):
        _close(o.numpy(), r, 1e-5, f"{variant}.{name}")
    chi, d_alpha, d_gamma = (o.numpy() for o in out)
    assert np.isnan(d_alpha[EMPTY]) and np.isnan(ref[variant][1][EMPTY])
    assert d_gamma[EMPTY] == 1.0 and chi[EMPTY] == 1.0
    alive = np.ones(CELLS, bool)
    alive[EMPTY] = False
    assert np.isfinite(d_alpha[alive]).all() and ((chi >= 0) & (chi <= 1)).all()
    assert (chi[alive] < 1.0).all() and (d_gamma[alive] > d_alpha[alive] - 1e-4).all()


def test_pm_mass_and_bin_average_comp(case):
    ref, t, _ = case
    _close(diagnostics.pm_mass(t["aero"], t["ad"], 1e-6, t["env"].cell_volume).numpy(),
           ref["pm"], 1e-5, "pm1")
    avg = diagnostics.bin_average_comp(t["aero"], t["ad"], t["bg"])
    _close(avg.vol.numpy(), ref["avg"], 1e-5, "bin_average_comp vol")
    dry = t["aero"].dry_diameter(t["ad"])
    np.testing.assert_allclose(avg.dry_diameter(t["ad"]).numpy(), dry.numpy(), rtol=1e-5)


RTOL = dict(b_scat=1e-4, b_abs=1e-4, b_scat_mix=1e-4, b_abs_mix=1e-4)


@pytest.mark.parametrize("advanced", [True, False], ids=["advanced", "basic"])
def test_process(case, advanced):
    ref, t, _ = case
    out = to_numpy(diagnostics.process(t["aero"], t["ad"], t["env"], t["bg"],
                                       advanced=advanced))
    r = ref["advanced" if advanced else "basic"]
    for f in dataclasses.fields(out):
        _close(getattr(out, f.name), getattr(r, f.name), RTOL.get(f.name, 1e-5), f.name)
    if advanced:
        assert (out.b_scat > 0).sum() == out.b_scat.size - 1       # all but the empty cell
        assert (out.ccn_mix[..., -1] > 0).sum() == out.chi.size - 1
    else:
        assert not out.b_scat.any() and not out.ccn_mix.any()
    assert np.isnan(out.d_alpha[EMPTY]) and out.chi[EMPTY] == 1.0
    assert out.num_conc[EMPTY] == 0.0 and not out.num_dist[EMPTY].any()
