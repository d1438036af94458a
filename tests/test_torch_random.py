"""The port's threefry streams against jax.random on the CPU.

key / fold_in / split / uniform / randint must be bitwise equal (pure
integer hashing, then an exact bit-to-float map).  normal goes through
``rng.erfinv_xla``, the float32 erfinv of XLA-CPU (its log, log1p and fused
multiply-adds reproduced op for op), and must be bitwise equal too; its
draws must not depend on the thread count, on where a thread's chunk
starts, or on which process draws them.  categorical must pick the same
category at these sizes (no flips).
"""

import subprocess
import sys
from pathlib import Path

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


# spans past 2^16 take jax's wrapped uint32 multiplier (0 for span > 2^16)
@pytest.mark.parametrize("lo,hi", [(0, 4), (0, 10), (-3, 17), (0, 1000), (5, 5),
                                   (0, 70000), (-2**31, 2**31 - 1)])
def test_randint_scalar_bitwise(lo, hi):
    for step in range(64):
        k = jax.random.fold_in(jax.random.key(5), step)
        assert int(jax.random.randint(k, (), lo, hi)) == rng.randint_scalar(kd(k), lo, hi)


def test_normal_within_ulps():
    k = jax.random.key(21)
    a = np.asarray(jax.random.normal(k, (20000,)))
    b = rng.normal(kd(k), (20000,), "cpu").numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 21, 7777])
def test_normal_bitwise(seed):
    """Every one of 200,000 draws bit-equal to jax.random.normal (both
    erfinv branches: w >= 5 holds for |u| > 0.9966, ~0.3% of draws)."""
    k = jax.random.key(seed)
    a = np.asarray(jax.random.normal(k, (200_000,)))
    b = rng.normal(kd(k), (200_000,), "cpu").numpy()
    share = np.mean(a.view(np.int32) == b.view(np.int32))
    assert share == 1.0, share


def test_erfinv_xla_chunk_invariant():
    """The same inputs give the same bits at any thread count and at any
    offset into the tensor (vector bodies and scalar tails fall on other
    elements)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = rng.uniform((0, 99), (100_003,), "cpu", lo, 1.0)
    ref = rng.erfinv_xla(u).numpy().view(np.int32)
    n0 = torch.get_num_threads()
    try:
        for nt in (1, 2, 3, 5):
            torch.set_num_threads(nt)
            np.testing.assert_array_equal(rng.erfinv_xla(u).numpy().view(np.int32), ref)
    finally:
        torch.set_num_threads(n0)
    for off in (1, 3, 7, 13):
        np.testing.assert_array_equal(
            rng.erfinv_xla(u[off:].clone()).numpy().view(np.int32), ref[off:])


_DRAW = ("import hashlib, sys, torch; torch.set_num_threads(int(sys.argv[1]));"
         "from wrf_partmc_tpu_torch.utils import rng;"
         "z = rng.normal((0, 4321), (200000,), 'cpu');"
         "print(hashlib.sha256(z.numpy().tobytes()).hexdigest())")


def normal_digests(n_proc: int):
    """sha256 of the same 200,000 normals drawn by ``n_proc`` processes
    started together, each with its own thread count."""
    procs = [subprocess.Popen([sys.executable, "-c", _DRAW, str(1 + i % 4)],
                              stdout=subprocess.PIPE, text=True,
                              cwd=Path(__file__).resolve().parents[1])
             for i in range(n_proc)]
    return [p.communicate(timeout=120)[0].strip() for p in procs]


def test_normal_bits_equal_across_processes():
    digests = normal_digests(8)
    assert len(digests[0]) == 64 and len(set(digests)) == 1, digests


@pytest.mark.parametrize("m", [1, 2, 6])
def test_categorical_no_flips(m):
    k = jax.random.key(m)
    logits = np.log(np.random.default_rng(m).random((64, 48, m)) + 1e-3).astype(np.float32)
    a = np.asarray(jax.random.categorical(k, jnp.asarray(logits), axis=-1))
    b = rng.categorical(kd(k), torch.from_numpy(logits), axis=-1).numpy()
    np.testing.assert_array_equal(a, b)
