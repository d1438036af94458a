"""K2/K3 (row scatter and gather): the port's plain versions against the
JAX package, exactly.

Against the Pallas kernels (interpret mode) the payload values are integers
times powers of two with at most 16 significant bits, which the TPU's bf16x3
split carries exactly; so the comparison is exact there too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.ops.place import (_gather_rows_pallas, _scatter_rows_pallas,
                                      gather_rows_ref, scatter_rows_ref)
from wrf_partmc_tpu_torch.ops import place

# (B, CH, L1, L2): the transport T1 (P -> F1) and T2 (AB -> AB, AB -> P)
# proportions and the coagulation pairing (P -> P) at test capacity 48
SHAPES = [(6, 33, 48, 128), (6, 33, 80, 80), (5, 33, 80, 48), (4, 33, 48, 48),
          (3, 7, 40, 64)]


def _payload(seed, B, CH, L):
    r = np.random.default_rng(seed)
    mant = r.integers(-2 ** 15, 2 ** 15, size=(B, CH, L))
    expo = r.integers(-30, 30, size=(B, CH, L))
    return np.ldexp(mant.astype(np.float64), expo).astype(np.float32)


def _dst(seed, B, L1, L2):
    r = np.random.default_rng(seed)
    n = min(L1, L2)
    dst = np.full((B, L1), -1, np.int32)
    for b in range(B):
        dst[b, r.permutation(L1)[:n]] = r.permutation(L2)[:n]
    dst[r.random((B, L1)) < 0.2] = -1
    return dst


def _src(seed, B, L1, L2):
    return np.random.default_rng(seed).integers(-1, L1, size=(B, L2)).astype(np.int32)


@pytest.mark.parametrize("B,CH,L1,L2", SHAPES)
def test_scatter_plain_matches_jax_exactly(B, CH, L1, L2):
    x, dst = _payload(0, B, CH, L1), _dst(1, B, L1, L2)
    out = place.scatter_rows(torch.from_numpy(x), torch.from_numpy(dst), L2).numpy()
    np.testing.assert_array_equal(out, np.asarray(scatter_rows_ref(jnp.asarray(x), jnp.asarray(dst), L2)))
    np.testing.assert_array_equal(out, np.asarray(_scatter_rows_pallas(
        jnp.asarray(x), jnp.asarray(dst), L2, interpret=True)))


@pytest.mark.parametrize("B,CH,L1,L2", SHAPES)
def test_gather_plain_matches_jax_exactly(B, CH, L1, L2):
    x, src = _payload(2, B, CH, L1), _src(3, B, L1, L2)
    out = place.gather_rows(torch.from_numpy(x), torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(out, np.asarray(gather_rows_ref(jnp.asarray(x), jnp.asarray(src))))
    np.testing.assert_array_equal(out, np.asarray(_gather_rows_pallas(
        jnp.asarray(x), jnp.asarray(src), interpret=True)))


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 3, 8))
    idx = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        place.scatter_rows_cuda(x, idx, 8)
    with pytest.raises(ValueError):
        place.gather_rows_cuda(x, idx)


@pytest.mark.parametrize("B,CH,L1,L2", SHAPES)
def test_out_of_range_indices_drop(B, CH, L1, L2):
    """Indices outside [0, L) act as -1 (the function the CUDA kernels
    compute): the scatter drops the row and the gather writes zeros, as the
    JAX package does for -1."""
    r = np.random.default_rng(4)
    x, dst, src = _payload(5, B, CH, L1), _dst(6, B, L1, L2), _src(7, B, L1, L2)
    far_d = np.where(r.random(dst.shape) < 0.5, L2 + r.integers(0, 9, dst.shape),
                     -2 - r.integers(0, 9, dst.shape)).astype(np.int32)
    bad_d = (dst < 0) & (r.random(dst.shape) < 0.5)
    far_s = np.where(r.random(src.shape) < 0.5, L1 + r.integers(0, 9, src.shape),
                     -2 - r.integers(0, 9, src.shape)).astype(np.int32)
    bad_s = r.random(src.shape) < 0.2
    out = place.scatter_rows(torch.from_numpy(x), torch.from_numpy(np.where(bad_d, far_d, dst)),
                             L2).numpy()
    np.testing.assert_array_equal(out, np.asarray(scatter_rows_ref(jnp.asarray(x),
                                                                   jnp.asarray(dst), L2)))
    out = place.gather_rows(torch.from_numpy(x),
                            torch.from_numpy(np.where(bad_s, far_s, src))).numpy()
    np.testing.assert_array_equal(out, np.asarray(gather_rows_ref(
        jnp.asarray(x), jnp.asarray(np.where(bad_s, -1, src)))))
