"""The port's threefry streams against jax.random on the CPU.

key / fold_in / split / uniform / randint must be bitwise equal (pure
integer hashing, then an exact bit-to-float map).  normal goes through
erfinv, whose torch and XLA implementations differ in the last ulps (more
in the tails, where erfinv is ill-conditioned); the tolerance is 1e-5
relative plus 1e-6 absolute, far below any physically meaningful size
difference.  categorical must pick the same
category at these sizes (no flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu_torch.utils import rng


def kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1])
def test_key_fold_in_split_bitwise(seed):
    kj, kt = jax.random.key(seed), rng.key(seed)
    assert kd(kj) == kt
    for step, stream in [(0, 1), (7, 3), (123456, 5)]:
        a = jax.random.fold_in(jax.random.fold_in(kj, stream), step)
        b = rng.step_key(kt, step, stream)
        assert kd(a) == b
        for n in (2, 3):
            assert [kd(x) for x in jax.random.split(a, n)] == list(rng.split(b, n))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 7), (4, 4, 2, 48)])
def test_uniform_bitwise(shape):
    k = jax.random.fold_in(jax.random.key(3), 11)
    a = np.asarray(jax.random.uniform(k, shape))
    b = rng.uniform(kd(k), shape, "cpu").numpy()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_uniform_range_bitwise():
    k = jax.random.key(9)
    lo = float(np.finfo(np.float32).tiny)
    a = np.asarray(jax.random.uniform(k, (1000,), minval=lo, maxval=1.0))
    np.testing.assert_array_equal(a, rng.uniform(kd(k), (1000,), "cpu", lo, 1.0).numpy())


@pytest.mark.parametrize("lo,hi", [(0, 4), (0, 10), (-3, 17), (0, 1000), (5, 5)])
def test_randint_scalar_bitwise(lo, hi):
    for step in range(64):
        k = jax.random.fold_in(jax.random.key(5), step)
        assert int(jax.random.randint(k, (), lo, hi)) == rng.randint_scalar(kd(k), lo, hi)


def test_normal_within_ulps():
    k = jax.random.key(21)
    a = np.asarray(jax.random.normal(k, (20000,)))
    b = rng.normal(kd(k), (20000,), "cpu").numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [1, 2, 6])
def test_categorical_no_flips(m):
    k = jax.random.key(m)
    logits = np.log(np.random.default_rng(m).random((64, 48, m)) + 1e-3).astype(np.float32)
    a = np.asarray(jax.random.categorical(k, jnp.asarray(logits), axis=-1))
    b = rng.categorical(kd(k), torch.from_numpy(logits), axis=-1).numpy()
    np.testing.assert_array_equal(a, b)
