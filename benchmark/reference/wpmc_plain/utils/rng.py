"""Deterministic, decomposition-invariant random streams.

The port's explicit generator: a threefry2x32 counter-based stream that
reproduces ``jax.random`` bit for bit (``jax_threefry_partitionable=True``,
the default of jax 0.9), so every stochastic process of the port draws the
same numbers as the JAX package from the same key.

A key is a :class:`Key`, a pair of Python ints ``(k0, k1)``, each a
uint32 value.  Key arithmetic (``key``, ``fold_in``, ``split``) runs on the host in Python
integers and never touches the device.  Bulk draws (``random_bits``,
``uniform``, ``normal`` and the samplers built on them) run on the device
of the caller's choosing: on a CUDA device one launch of the hand-written
kernel K4 (``ops/threefry.py``, ``csrc/threefry.cu``), which raises if it
cannot run; on the CPU the plain version, :func:`draw_plain`, with the
uint32 words carried in int64 tensors and masked with ``& 0xFFFFFFFF``
after every add.  The two give the same bits.

Every stochastic site derives its key from (base_seed, step, substream-tag),
exactly as ``wrf_partmc_tpu/utils/rng.py`` does.

Element i of a draw hashes only its row-major index i, so a rank of the
domain decomposition can draw just its horizontal block of a global-shape
draw (a :class:`Block`): the block's elements hash their global indices,
and the result equals the slice of the global draw bit for bit.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

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



class Key(tuple):
    """A threefry key ``(k0, k1)``; its own type, so that the decomposed
    step can find the keys among a call's arguments and fold them with the
    rank's block index."""


@dataclass(frozen=True)
class Block:
    """A rank's horizontal block of a global draw: rows ``iy0 .. iy0+ny_l``
    of ``ny`` and columns ``ix0 .. ix0+nx_l`` of ``nx`` on axes 1 and 2 of a
    draw shaped ``(n0, ny, nx, *trail)``, as the cell fields lay them out."""

    ny: int
    nx: int
    iy0: int
    ix0: int
    ny_l: int
    nx_l: int

    def kernel_args(self, shape) -> tuple:
        """K4's block arguments ``(ny, nx, iy0, ix0, ny_l, nx_l, trail)`` for
        the block draw ``shape`` (``(n0, ny_l, nx_l, *trail)``); the kernel
        hashes the same indices as :meth:`flat_index`."""
        shape = tuple(shape)
        if len(shape) < 3 or shape[1:3] != (self.ny_l, self.nx_l):
            raise ValueError(f"block draw of shape {shape}: axes 1, 2 must be "
                             f"({self.ny_l}, {self.nx_l})")
        return (self.ny, self.nx, self.iy0, self.ix0, self.ny_l, self.nx_l,
                math.prod(shape[3:]))

    def flat_index(self, shape, device) -> torch.Tensor:
        """int64 global row-major indices of the block draw ``shape``
        (``(n0, ny_l, nx_l, *trail)``) within the global draw."""
        shape = tuple(shape)
        trail = self.kernel_args(shape)[-1]
        ar = lambda a, n: torch.arange(a, a + n, dtype=torch.int64, device=device)
        cell = ((ar(0, shape[0]).reshape(-1, 1, 1) * self.ny
                 + ar(self.iy0, self.ny_l).reshape(1, -1, 1)) * self.nx
                + ar(self.ix0, self.nx_l).reshape(1, 1, -1))
        idx = cell.reshape(-1, 1) * trail + ar(0, trail).reshape(1, -1)
        return idx.reshape(shape)


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
    return Key((0, int(seed) & _M))


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash the counter pair (0, data) under k."""
    return Key(threefry2x32(k[0], k[1], 0, int(data) & _M))


def split(k: Key, num: int = 2) -> tuple:
    """``jax.random.split`` (fold-like partitionable form): key i hashes the
    counter pair (0, i)."""
    return tuple(Key(threefry2x32(k[0], k[1], 0, i)) for i in range(num))


def base_key(seed: int) -> Key:
    return key(seed)


def step_key(k: Key, step: int, stream: int) -> Key:
    """Key for (step, subsystem)."""
    return fold_in(fold_in(k, stream), step)


def name_seed(name: str) -> int:
    """A stable 31-bit seed from a string (named ensembles and tests)."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little") & 0x7FFFFFFF


def random_bits_plain(k: Key, shape, device, block: Block | None = None) -> torch.Tensor:
    """32 random bits per element (int64 tensor of uint32 values): the
    element with row-major index n hashes the counter pair (n >> 32,
    n & 0xFFFFFFFF), and the two output words are xor-ed.  With ``block``,
    ``shape`` is the block's and n its elements' global index.  The plain
    version, on any device."""
    shape = tuple(shape)
    if block is None:
        idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    else:
        idx = block.flat_index(shape, device).reshape(-1)
    y0, y1 = threefry2x32(k[0], k[1], idx >> 32, idx & _M)
    return (y0 ^ y1).reshape(shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): 23 mantissa bits under exponent 0."""
    one = 0x3F800000
    fb = ((bits >> 9) | one).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def _lo_span(minval: float, maxval: float) -> tuple:
    """``jax.random.uniform``'s float32 range: (lo, maxval - lo), each
    rounded to float32."""
    lo = np.float32(minval)
    return float(lo), float(np.float32(np.float32(maxval) - lo))


def _fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, as the fused multiply-add of
    XLA-CPU's code: the float32 product is exact in float64, so the float64
    sum rounded once more to float32 is the fused result (but for ties of
    probability ~2^-29).  A float64 operand (a float32 value cast once
    for reuse) is taken as it is."""
    a = a.double() if torch.is_tensor(a) else a
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a * b + c).float()


# XLA-CPU's float32 log (Eigen's Cephes plog, Estrin form, with the fused
# multiply-adds of its code generator), its log1p (Cephes rational below
# |x| < sqrt(2) - 1) and the erf_inv of the CHLO lowering (Giles 2010).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 log of x > 0, bit for bit."""
    x = torch.clamp(x, min=_f32(1.17549435e-38))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < _f32(0.707106781186547524)
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    m64, x3_64 = m.double(), x3.double()
    p = [_f32(v) for v in _LOG_P]
    y = _fma(_fma(m64, p[0], p[1]), m64, p[2])
    y1 = _fma(_fma(m64, p[3], p[4]), m64, p[5])
    y2 = _fma(_fma(m64, p[6], p[7]), m64, p[8])
    y = _fma(_fma(y, x3_64, y1), x3_64, y2)
    y = _fma(y, x3_64, e * _f32(-2.12194440e-4))
    r = (m - 0.5 * x2) + y
    return _fma(e, _f32(0.693359375), r)


def _xla_log1p(a: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 log1p, bit for bit."""
    a64 = a.double()

    def horner(coeffs):
        p = torch.zeros_like(a)
        for cc in coeffs:
            p = _fma(p, a64, _f32(cc))
        return p

    a2 = a * a
    s = a + (-0.5 * a2 + (a * a2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN)))
    return torch.where(torch.abs(a) < _f32(0.41421356237309504880), s,
                       _xla_log(a + 1.0))


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as ``jax.lax.erf_inv`` runs on XLA-CPU (Giles' two
    branches on w = -log1p(-x^2), split at w = 5).  Every step is an
    elementwise float32/float64 add, multiply, divide, float64 sqrt or bit
    operation, each correctly rounded in scalar and vector code alike, so
    the result does not depend on how the work is chunked across threads
    (``torch.erfinv`` on the CPU did)."""
    w = -_xla_log1p(x * -x)
    lt5 = w < 5.0
    # torch's float32 sqrt on the CPU is not correctly rounded; the float64
    # root rounded to float32 is
    ww = torch.where(lt5, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    ww64 = ww.double()
    p = torch.where(lt5, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, ww64, torch.where(lt5, _f32(c_lt), _f32(c_ge)))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


# normal's uniform on (nextafter(-1, 0), 1) and the float32 sqrt(2)
NORMAL_LO, NORMAL_SPAN = _lo_span(float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0)
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def draw_plain(mode: str, k: Key, shape, device, lo: float = 0.0, span: float = 1.0,
               block: Block | None = None) -> torch.Tensor:
    """K4's plain version, on any device: :func:`random_bits_plain`'s bits
    (``"bits"``); their float32 uniform ``clamp(f * span + lo, min=lo)``
    (``"uniform"``); or sqrt(2) times :func:`erfinv_xla` of that uniform
    (``"normal"``, with ``NORMAL_LO``/``NORMAL_SPAN``)."""
    bits = random_bits_plain(k, shape, device, block)
    if mode == "bits":
        return bits
    u = torch.clamp(_bits_to_unit(bits) * span + lo, min=lo)
    if mode == "uniform":
        return u
    if mode != "normal":
        raise ValueError(f"draw_plain: unknown mode {mode!r}")
    return _SQRT2 * erfinv_xla(u)


def _draw(mode: str, k: Key, shape, device, lo: float = 0.0, span: float = 1.0,
          block: Block | None = None) -> torch.Tensor:
    """The plain version on every device."""
    return draw_plain(mode, k, shape, device, lo, span, block)


def random_bits(k: Key, shape, device, block: Block | None = None) -> torch.Tensor:
    """32 random bits per element as :func:`random_bits_plain` draws them
    (K4 on a CUDA device)."""
    return _draw("bits", k, shape, device, block=block)


def uniform(k: Key, shape, device, minval: float = 0.0,
            maxval: float = 1.0, block: Block | None = None) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (``block``: see :func:`random_bits_plain`)."""
    return _draw("uniform", k, shape, device, *_lo_span(minval, maxval), block)


def normal(k: Key, shape, device, block: Block | None = None) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u), u uniform on
    (nextafter(-1, 0), 1), with XLA-CPU's erfinv (:func:`erfinv_xla`), so the
    draws equal the JAX package's bit for bit on the CPU."""
    return _draw("normal", k, shape, device, NORMAL_LO, NORMAL_SPAN, block)



def gumbel(k: Key, shape, device, block: Block | None = None) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(k, shape, device, tiny, 1.0, block)
    return -torch.log(-torch.log(u))


def categorical(k: Key, logits: torch.Tensor, axis: int = -1,
                block: Block | None = None) -> torch.Tensor:
    """``jax.random.categorical`` with replacement (gumbel-max trick).
    Returns int64 indices of shape ``logits.shape`` without ``axis``."""
    g = gumbel(k, logits.shape, logits.device, block)
    return torch.argmax(g + logits, dim=axis)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values in int64 without overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def randint(k: Key, shape, device, minval: int, maxval: int,
            block: Block | None = None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32 results
    (int64 tensor): two 32-bit draws reduced modulo the span, as jax does
    (``block``: see :func:`random_bits_plain`)."""
    k1, k2 = split(k)
    span = (maxval - minval) & _M if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M) % span        # the uint32 product wraps, as in jax
    hi = random_bits(k1, shape, device, block) % span
    lo = random_bits(k2, shape, device, block) % span
    return minval + ((_mul32(hi, mult) + lo) & _M) % span


def randint_scalar(k: Key, minval: int, maxval: int) -> int:
    """``jax.random.randint(k, (), minval, maxval)`` as a Python int."""
    return int(randint(k, (), "cpu", minval, maxval))
