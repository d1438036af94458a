"""One decomposed CARES-shaped step of the port against the JAX package's
mesh path at (2, 2), block by block, on the CPU.

``cares.build_cares_shape(mesh=...)`` at 12x10x8 (16 particles per cell,
capacity 32, chemistry on) steps once on 4 gloo ranks against
``tools/cares_shape.py::build_cares_shape(mesh=...)`` on a (2, 2) mesh of
the conftest's virtual CPU devices.  This is the decomposed step's every
branch beyond em_uniform: open boundaries (the inflow resampling's block
draw, the gas BC on the block, outflow drops at the global edges, the
specified and relaxation zones of the wrfbdy painted from the global
indices), the aerosol optics, the radiation and their photolysis
attenuation on the block, the MYJ 1/L and the geopotential first-layer
depth on the block for the deposition, and the chemistry on the block
with its folded key.  Every rank holds and advances only its block of
every field, and the step gathers nothing.  The ranks run with float32 subnormals flushed
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
rtol 1e-5.  Against the port's own undecomposed step (same flush), the
dycore, Noah and MYJ blocks are bit-equal but for theta' and the Noah
fields: on the CPU ``torch.pow`` with a non-integer exponent (the
radiation's ``** 0.635`` and ``** 0.8``, Noah's ``** (1 / kappa)``)
rounds ~1 ulp differently in ATen's vectorised loop and its scalar tail,
and which elements fall in the tail depends on the tensor's size; those
fields agree within 1e-6 of their scale.
"""

import concurrent.futures
import os
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_sharded import aero_block, block, ranks_in_background
from wrf_partmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_partmc_tpu_torch.cares import build_cares_shape
from wrf_partmc_tpu_torch.convert import to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from cares_shape import build_cares_shape as jax_build_cares_shape  # noqa: E402

SHAPE = (12, 10, 8)
KW = dict(n_part=16, cap=32, chem_on=True)
ATOL = {"w": 1e-5, "ph": 1e-3}


def _plain():
    """The port's undecomposed CARES step, with subnormals flushed as the
    ranks run."""
    flushed = torch.set_flush_denormal(True)
    try:
        model, state = build_cares_shape(*SHAPE, **KW, device="cpu")
        return to_numpy(model(state))
    finally:
        torch.set_flush_denormal(False)
        assert flushed


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """(the JAX (2, 2) step, its initial state, each rank's step and
    collectives, the port's undecomposed step); the references are computed
    while the ranks step."""
    outs = ranks_in_background(tmp_path_factory.mktemp("cares"), "cares",
                               dict(kind="cares", args=SHAPE, kw=KW, flush_denormal=True))
    mesh = jax_make_mesh(jax.devices()[:4], shape=(2, 2))
    fn, cs, _, _ = jax_build_cares_shape(*SHAPE, **KW, mesh=mesh)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        step = pool.submit(jax.jit(fn).lower(cs).compile)   # beside the port's step
        whole = _plain()
        ref = jax.tree.map(np.asarray, step.result()(cs))
    j0 = jax.tree.map(np.asarray, cs)
    return ref, j0, [(to_numpy(o), counts) for o, counts in outs.result()], whole


@pytest.fixture(scope="module")
def runs(stepped):
    return stepped[:3]


@pytest.fixture(scope="module")
def plain(stepped):
    return stepped[3]


def yx_block(a, rank):
    return block(a, *divmod(rank, 2), 2, 2, axes=(-2, -1))


DYN = ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem", "num_conc", "tke"]


@pytest.mark.parametrize("name", DYN)
def test_dycore_on_every_rank(runs, name):
    """Each rank's block of the dycore field against the same block of the
    JAX (2, 2) result."""
    ref, _, outs = runs
    r = getattr(ref.dyn, name)
    atol = max(ATOL.get(name, 0.0), 1e-4 * float(np.abs(r).max()))
    for rank, (out, _) in enumerate(outs):
        np.testing.assert_allclose(getattr(out.dyn, name), yx_block(r, rank), rtol=1e-4,
                                   atol=atol, err_msg=f"rank {rank}")


# fields within this share of their scale of the undecomposed step (the
# module docstring: torch.pow's vectorised tail); every other is bit-equal
POW_TOL = 1e-6


def test_blocks_equal_undecomposed(runs, plain):
    """The decomposed step's dycore, Noah and MYJ blocks against the port's
    undecomposed step; open boundaries gather nothing either."""
    _, _, outs = runs
    fields = [("dyn", n) for n in DYN] + [("land", n) for n in ("tsk", "t_soil", "smois")]
    for rank, (out, counts) in enumerate(outs):
        for group, name in fields:
            o, r = getattr(getattr(out, group), name), yx_block(
                getattr(getattr(plain, group), name), rank)
            if name in ("theta_p", "tsk", "t_soil", "smois"):
                np.testing.assert_allclose(o, r, rtol=0, atol=POW_TOL * float(np.abs(r).max()),
                                           err_msg=f"rank {rank} {name}")
            else:
                np.testing.assert_array_equal(o, r, err_msg=f"rank {rank} {name}")
        np.testing.assert_array_equal(out.pbl_q2, yx_block(plain.pbl_q2, rank))
        assert counts["all_gather"]["calls"] == 0, counts


def test_gases_by_block(runs):
    ref, j0, outs = runs
    assert np.abs(ref.gas - j0.gas).max() > 1e-3            # the chemistry ran
    for rank, (out, _) in enumerate(outs):
        np.testing.assert_allclose(out.gas, block(ref.gas, *divmod(rank, 2), 2, 2),
                                   rtol=1e-4, atol=1e-9, err_msg=f"rank {rank}")


def test_particles_by_block(runs):
    ref, _, outs = runs
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    for rank, (out, _) in enumerate(outs):
        ja, ta = aero_block(ref.aero, *divmod(rank, 2), 2, 2), out.aero
        np.testing.assert_array_equal(ta.num > 0, ja.num > 0)
        np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
        np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
        np.testing.assert_array_equal(ta.next_id, ja.next_id)
        assert out.step == int(ref.step) == 1


def test_land_and_pbl_on_every_rank(runs):
    """Each rank's block of the Noah and MYJ states against the same block
    of the JAX result."""
    ref, j0, outs = runs
    assert np.abs(ref.land.tsk - j0.land.tsk).max() > 1e-3   # the LSM ran
    for rank, (out, _) in enumerate(outs):
        for f in ("tsk", "t_soil", "smois"):
            np.testing.assert_allclose(getattr(out.land, f),
                                       yx_block(getattr(ref.land, f), rank), rtol=1e-5,
                                       err_msg=f)
        np.testing.assert_allclose(out.pbl_q2, yx_block(ref.pbl_q2, rank), rtol=1e-5,
                                   atol=1e-7)
