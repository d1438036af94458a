"""Deterministic, decomposition-invariant random streams.

The port's explicit generator: a threefry2x32 counter-based stream that
reproduces ``jax.random`` bit for bit (``jax_threefry_partitionable=True``,
the default of jax 0.9), so every stochastic process of the port draws the
same numbers as the JAX package from the same key.

A key is a pair of Python ints ``(k0, k1)``, each a uint32 value.  Key
arithmetic (``key``, ``fold_in``, ``split``) runs on the host in Python
integers and never touches the device; bulk draws (``random_bits`` and the
samplers built on it) run on the device of the caller's choosing, with the
uint32 words carried in int64 tensors and masked with ``& 0xFFFFFFFF``
after every add, so the same code runs on CPU and CUDA.

Every stochastic site derives its key from (base_seed, step, substream-tag),
exactly as ``wrf_partmc_tpu/utils/rng.py`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAM_INIT = 0
STREAM_COAG = 1
STREAM_EMISSION = 2
STREAM_TRANSPORT = 3
STREAM_DEPOSITION = 4
STREAM_REBALANCE = 5
STREAM_BC = 6

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), the hash behind
    ``jax.random``.  ``k0``/``k1`` are Python ints; ``x0``/``x1`` are Python
    ints or int64 tensors holding uint32 values.  Returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a 32-bit seed: the high word is zero."""
    return (0, int(seed) & _M)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash the counter pair (0, data) under k."""
    return threefry2x32(k[0], k[1], 0, int(data) & _M)


def split(k: Key, num: int = 2) -> tuple:
    """``jax.random.split`` (fold-like partitionable form): key i hashes the
    counter pair (0, i)."""
    return tuple(threefry2x32(k[0], k[1], 0, i) for i in range(num))


def base_key(seed: int) -> Key:
    return key(seed)


def step_key(k: Key, step: int, stream: int) -> Key:
    """Key for (step, subsystem)."""
    return fold_in(fold_in(k, stream), step)


def random_bits(k: Key, shape, device) -> torch.Tensor:
    """32 random bits per element (int64 tensor of uint32 values): the
    element with row-major index n hashes the counter pair (n >> 32,
    n & 0xFFFFFFFF), and the two output words are xor-ed."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k[0], k[1], idx >> 32, idx & _M)
    return (y0 ^ y1).reshape(shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): 23 mantissa bits under exponent 0."""
    one = 0x3F800000
    fb = ((bits >> 9) | one).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(k: Key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    lo = np.float32(minval)
    span = float(np.float32(np.float32(maxval) - lo))
    f = _bits_to_unit(random_bits(k, shape, device))
    return torch.clamp(f * span + float(lo), min=float(lo))


def normal(k: Key, shape, device) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u), u uniform on
    (nextafter(-1, 0), 1).  torch's erfinv and XLA's differ in the last
    ulps, so draws agree to a few ulp, not bit for bit."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, device, lo, 1.0)
    return float(np.float32(np.sqrt(2.0))) * torch.erfinv(u)


def gumbel(k: Key, shape, device) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(k, shape, device, tiny, 1.0)
    return -torch.log(-torch.log(u))


def categorical(k: Key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement (gumbel-max trick).
    Returns int64 indices of shape ``logits.shape`` without ``axis``."""
    g = gumbel(k, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=axis)


def randint_scalar(k: Key, minval: int, maxval: int) -> int:
    """``jax.random.randint(k, (), minval, maxval)`` for an int32 result,
    as a Python int computed on the host: two 32-bit draws reduced modulo
    the span, exactly as jax does."""
    def bits(kk):
        y0, y1 = threefry2x32(kk[0], kk[1], 0, 0)
        return y0 ^ y1

    k1, k2 = split(k)
    span = (maxval - minval) & _M if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((bits(k1) % span) * mult) & _M) + (bits(k2) % span)
    return minval + (off & _M) % span
