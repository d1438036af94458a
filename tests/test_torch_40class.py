"""The CARES-width weight-class universe: ``build(n_sources=38)`` against
``__graft_entry__._build(n_sources=38)`` (chemistry off) at 12x12x4, 16
particles per cell, capacity 48.  The 38 programmatic sources and the
background give 39 weight classes (``n_class`` 39), the reference's CARES
~40.  One step is compared as ``tests/test_torch_coupled.py`` does: alive
count per cell exact, represented number per cell rtol 1e-5, the 39 class
tracers rtol 1e-4 with a floor of 1e-4 of their scale, and number per
weight class over the domain rtol 1e-5.
"""

import jax
import numpy as np
import pytest

import __graft_entry__ as ge
from wrf_partmc_tpu_torch.convert import to_numpy
from wrf_partmc_tpu_torch.entry import build


@pytest.fixture(scope="module")
def runs():
    fn, cs = ge._build(nx=12, ny=12, nz=4, n_part=16, cap=48, chem_on=False, n_sources=38)
    model, state = build(12, 12, 4, n_part=16, cap=48, n_sources=38, device="cpu")
    return jax.tree.map(np.asarray, jax.jit(fn)(cs)), to_numpy(model(state)), model


def test_universe_width(runs):
    j, t, model = runs
    assert model.cfg.n_class == 39
    assert t.dyn.num_conc.shape == j.dyn.num_conc.shape == (39, 4, 12, 12)


def test_one_step_per_cell(runs):
    j, t, _ = runs
    np.testing.assert_array_equal((t.aero.num > 0).sum(-1), (j.aero.num > 0).sum(-1))
    np.testing.assert_allclose(t.aero.num.sum(-1), j.aero.num.sum(-1), rtol=1e-5)
    np.testing.assert_allclose(t.dyn.num_conc, j.dyn.num_conc, rtol=1e-4,
                               atol=1e-4 * np.abs(j.dyn.num_conc).max())


def test_one_step_class_totals(runs):
    """Number per weight class, every class."""
    j, t, model = runs
    for c in range(model.cfg.n_class):
        np.testing.assert_allclose((t.aero.num * (t.aero.w_class == c)).sum(),
                                   (j.aero.num * (j.aero.w_class == c)).sum(),
                                   rtol=1e-5, err_msg=f"class {c}")
