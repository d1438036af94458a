"""K1 (Thomas solve): the port's plain version against the JAX package,
and the kernel's launch plan at the shapes the paths give it.

The plain recurrence performs the same float32 divisions as the JAX scan
(tolerance 1e-6 relative, for summation-free rounding differences); the
Pallas kernel in interpret mode multiplies by 1/denom instead, so it is
held at 1e-5 relative on diagonally dominant systems.  ``launch_plan`` is
the pure function that makes every layout decision of a CUDA launch (level
bucket, block size, column counts, strides, descriptor table), so its
choices are checked here, where the kernel itself cannot run.
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
        tridiag.thomas_solve(dl, d, du, [b])


@pytest.mark.parametrize("shape,expect", [((10, 1, 5, 7), 35), ((10, 3, 5, 7), 105),
                                          ((10, 1, 1, 1), 1), ((10, 3, 1, 7), 0),
                                          ((1, 3, 5, 7), 0)])
def test_column_count(shape, expect):
    assert tridiag._column_count(shape, (10, 3, 5, 7)) == expect


def _plan(cshape, fshapes, cols=None, strides=None):
    if strides is None:
        strides = tuple(torch.empty(s).stride() for s in fshapes)
    return tridiag.launch_plan((cshape,) * 3, tuple(fshapes), strides, cols)


VDIFF_FIELDS = [(10, 40, 40)] * 3 + [(3, 10, 40, 40), (32, 10, 40, 40), (10, 40, 40)]

# (coefficients, fields, cols or None): bucket, threads, blocks, coefficient
# columns and per field (L, level stride, field stride, columns, block0)
PLANS = [
    ((9, 40, 40), [(9, 40, 40)], (40, 40),                      # acoustic W''
     16, 64, 25, 1600, [(1, 1600, 0, 1600, 0)]),
    ((23, 72, 72), [(23, 72, 72)], (72, 72),                    # MYJ q2, CARES acoustic
     24, 64, 81, 5184, [(1, 5184, 0, 5184, 0)]),
    ((4, 72, 72), [(4, 72, 72)], (72, 72),                      # Noah soil
     8, 64, 81, 5184, [(1, 5184, 0, 5184, 0)]),
    ((10, 40, 40), VDIFF_FIELDS, None,                          # chem-off vdiff, one launch
     16, 128, 490, 1600,
     [(1, 1600, 0, 1600, 0), (1, 1600, 0, 1600, 13), (1, 1600, 0, 1600, 26),
      (3, 1600, 16000, 4800, 39), (32, 1600, 16000, 51200, 77), (1, 1600, 0, 1600, 477)]),
    ((24, 72, 72), [(24, 72, 72)] * 3 + [(10, 24, 72, 72), (77, 24, 72, 72), (24, 72, 72)],
     None, 24, 128, 3688, 5184,                                 # CARES vdiff
     [(1, 5184, 0, 5184, 0), (1, 5184, 0, 5184, 41), (1, 5184, 0, 5184, 82),
      (10, 5184, 124416, 51840, 123), (77, 5184, 124416, 399168, 528),
      (1, 5184, 0, 5184, 3647)]),
    ((10, 1, 40, 40), [(10, 32, 40, 40)], (32, 40, 40),         # [n,1,ny,nx] by modulus
     16, 128, 400, 1600, [(1, 51200, 0, 51200, 0)]),
    ((65, 40, 40), [(65, 40, 40)], (40, 40),                    # the full CARES grid's levels
     0, 64, 25, 1600, [(1, 1600, 0, 1600, 0)]),
]


@pytest.mark.parametrize("cshape,fshapes,cols,bucket,threads,blocks,ccols,fields", PLANS)
def test_launch_plan_path_shapes(cshape, fshapes, cols, bucket, threads, blocks, ccols,
                                 fields):
    p = _plan(cshape, fshapes, cols)
    assert (p.n, p.bucket, p.threads, p.blocks) == (cshape[0], bucket, threads, blocks)
    assert p.coef_cols == (ccols,) * 3
    assert [(f.L, f.b_level, f.b_field, f.columns, f.block0) for f in p.fields] == fields
    assert p.window == (min(p.n, tridiag.WINDOW_BYTES // (8 * threads)) if bucket == 0 else 0)
    # every column of every field has exactly one thread
    assert sum(-(-f.columns // threads) for f in p.fields) == p.blocks


@pytest.mark.parametrize("n,bucket,window", [(1, 8, 0), (8, 8, 0), (9, 16, 0), (16, 16, 0),
                                             (17, 24, 0), (24, 24, 0), (25, 32, 0),
                                             (32, 32, 0), (33, 0, 33), (96, 0, 96),
                                             (200, 0, 96)])
def test_launch_plan_level_buckets(n, bucket, window):
    p = _plan((n, 5, 7), [(n, 5, 7)])
    assert (p.bucket, p.window) == (bucket, window)


def test_launch_plan_strided_fields():
    """A transposed stack and a level-sliced field keep their own strides."""
    stack = torch.empty(10, 3, 5, 7).transpose(0, 1)          # [3, 10, 5, 7], level stride 105
    sliced = torch.empty(12, 5, 7)[1:11]
    p = tridiag.launch_plan(((10, 5, 7),) * 3, ((3, 10, 5, 7), (10, 5, 7)),
                            (stack.stride(), sliced.stride()))
    assert [(f.L, f.b_level, f.b_field) for f in p.fields] == [(3, 105, 35), (1, 35, 0)]


BAD = [
    ((10, 5, 7), [(9, 5, 7)], None, None),                     # wrong number of levels
    ((10, 5, 7), [(3, 10, 5, 6)], None, None),                 # other columns
    ((10, 5, 7), [(2, 3, 10, 5, 7)], None, None),              # two stacking dims
    ((10, 5, 7), [(10, 5, 7)] * 9, None, None),                # more fields than the table
    ((10, 5, 7), [(10, 5, 7)], None, ((35, 1, 5),)),           # ny, nx transposed
    ((10, 3, 1, 7), [(10, 3, 5, 7)], (3, 5, 7), None),         # not a trailing broadcast
]


@pytest.mark.parametrize("cshape,fshapes,cols,strides", BAD)
def test_launch_plan_refuses(cshape, fshapes, cols, strides):
    with pytest.raises(ValueError):
        _plan(cshape, fshapes, cols, strides)
