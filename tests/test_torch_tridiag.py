"""K1 (Thomas solve): the port's plain version against the JAX package.

The plain recurrence performs the same float32 divisions as the JAX scan
(tolerance 1e-6 relative, for summation-free rounding differences); the
Pallas kernel in interpret mode multiplies by 1/denom instead, so it is
held at 1e-5 relative on diagonally dominant systems.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.ops.pallas_tridiag import solve_pallas
from wrf_partmc_tpu.ops.tridiag import solve_scan as jax_solve_scan
from wrf_partmc_tpu_torch.ops import tridiag


def _system(seed, cshape, bshape):
    r = np.random.default_rng(seed)
    f = lambda s: r.standard_normal(s).astype(np.float32)
    return f(cshape), (4.0 + np.abs(f(cshape))).astype(np.float32), f(cshape), f(bshape)


CASES = [((9, 6, 11), (9, 6, 11)),            # acoustic-like full coefficients
         ((10, 1, 5, 7), (10, 3, 5, 7)),      # vdiff: [n,1,ny,nx] against [n,L,ny,nx]
         ((8, 1, 1), (8, 3, 4))]              # column-constant coefficients


@pytest.mark.parametrize("cshape,bshape", CASES)
def test_plain_matches_jax_scan(cshape, bshape):
    dl, d, du, b = _system(1, cshape, bshape)
    ref = np.asarray(jax_solve_scan(*map(jnp.asarray, (dl, d, du, b))))
    out = tridiag.solve(*map(torch.from_numpy, (dl, d, du, b))).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cshape,bshape", CASES)
def test_plain_matches_pallas_interpret(cshape, bshape):
    dl, d, du, b = _system(2, cshape, bshape)
    ref = np.asarray(solve_pallas(*map(jnp.asarray, (dl, d, du, b)), interpret=True))
    out = tridiag.solve_scan(*map(torch.from_numpy, (dl, d, du, b))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_is_plain_and_kernel_refuses_cpu():
    dl, d, du, b = map(torch.from_numpy, _system(3, (5, 4), (5, 4)))
    before = tridiag.thomas_solve.launches
    tridiag.solve(dl, d, du, b)
    assert tridiag.thomas_solve.launches == before
    with pytest.raises(ValueError):
        tridiag.thomas_solve(dl, d, du, b)


@pytest.mark.parametrize("shape,expect", [((10, 1, 5, 7), 35), ((10, 3, 5, 7), 105),
                                          ((10, 1, 1, 1), 1), ((10, 3, 1, 7), 0),
                                          ((1, 3, 5, 7), 0)])
def test_column_count(shape, expect):
    assert tridiag._column_count(torch.zeros(shape), (10, 3, 5, 7)) == expect
