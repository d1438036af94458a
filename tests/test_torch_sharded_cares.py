"""One decomposed CARES-shaped step of the port against the JAX package's
mesh path at (2, 2), block by block, on the CPU.

``cares.build_cares_shape(mesh=...)`` at 12x10x8 (16 particles per cell,
capacity 32, chemistry on) steps once on 4 gloo ranks against
``tools/cares_shape.py::build_cares_shape(mesh=...)`` on a (2, 2) mesh of
the conftest's virtual CPU devices.  This is the decomposed step's every
branch beyond em_uniform: open boundaries (the inflow resampling's block
draw, the gas BC on the block, outflow drops at the global edges), the
aerosol optics gathered from the blocks for the radiation and their
photolysis attenuation on the block, the MYJ 1/L and the geopotential
first-layer depth sliced for the deposition, and the chemistry on the
block with its folded key.  The ranks run with float32 subnormals flushed
(``torch.set_flush_denormal``), as XLA-CPU runs the reference and as
tests/test_torch_box.py runs the chem-on box: ASTEM's NO3/Cl release
product is subnormal for ultrafine particles, the reference releases
nothing there and the port (unflushed) does, which moved the NO3 of four
emitted ultrafine particles by ~10% in this step (ROADMAP §3).  Tolerances
are those of the undecomposed
CARES test (tests/test_torch_cares_coupled.py): dycore fields rtol 1e-4
with a floor of 1e-4 of each field's scale (w and ph roundoff floors);
gases rtol 1e-4 with a 1e-9 ppb floor; per cell the alive mask slot for
slot, the represented number rtol 1e-5, the species volume rtol 1e-4
(floor 1e-6 of the largest) and the id counters exact; Noah and MYJ
rtol 1e-5.
"""

import os
import sys

import jax
import numpy as np
import pytest

from test_torch_sharded import aero_block, block, run_ranks
from wrf_partmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_partmc_tpu_torch.convert import to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from cares_shape import build_cares_shape as jax_build_cares_shape  # noqa: E402

SHAPE = (12, 10, 8)
KW = dict(n_part=16, cap=32, chem_on=True)
ATOL = {"w": 1e-5, "ph": 1e-3}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mesh = jax_make_mesh(jax.devices()[:4], shape=(2, 2))
    fn, cs, _, _ = jax_build_cares_shape(*SHAPE, **KW, mesh=mesh)
    ref = jax.tree.map(np.asarray, jax.jit(fn)(cs))
    j0 = jax.tree.map(np.asarray, cs)
    outs = run_ranks(tmp_path_factory.mktemp("cares"), "cares",
                     dict(kind="cares", args=SHAPE, kw=KW, flush_denormal=True))
    return ref, j0, [to_numpy(o) for o in outs]


@pytest.mark.parametrize("name", ["u", "v", "w", "theta_p", "p_p", "mu", "ph",
                                  "moist", "chem", "num_conc", "tke"])
def test_dycore_on_every_rank(runs, name):
    ref, _, outs = runs
    r = getattr(ref.dyn, name)
    atol = max(ATOL.get(name, 0.0), 1e-4 * float(np.abs(r).max()))
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(getattr(out.dyn, name), r, rtol=1e-4, atol=atol,
                                   err_msg=f"rank {rank}")


def test_gases_by_block(runs):
    ref, j0, outs = runs
    assert np.abs(ref.gas - j0.gas).max() > 1e-3            # the chemistry ran
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out.gas, block(ref.gas, *divmod(rank, 2), 2, 2),
                                   rtol=1e-4, atol=1e-9, err_msg=f"rank {rank}")


def test_particles_by_block(runs):
    ref, _, outs = runs
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    for rank, out in enumerate(outs):
        ja, ta = aero_block(ref.aero, *divmod(rank, 2), 2, 2), out.aero
        np.testing.assert_array_equal(ta.num > 0, ja.num > 0)
        np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
        np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
        np.testing.assert_array_equal(ta.next_id, ja.next_id)
        assert out.step == int(ref.step) == 1


def test_land_and_pbl_on_every_rank(runs):
    ref, j0, outs = runs
    assert np.abs(ref.land.tsk - j0.land.tsk).max() > 1e-3   # the LSM ran
    for out in outs:
        for f in ("tsk", "t_soil", "smois"):
            np.testing.assert_allclose(getattr(out.land, f), getattr(ref.land, f),
                                       rtol=1e-5, err_msg=f)
        np.testing.assert_allclose(out.pbl_q2, ref.pbl_q2, rtol=1e-5, atol=1e-7)
