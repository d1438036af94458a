"""Batched tridiagonal (Thomas) column solver.

Port of ``wrf_partmc_tpu/ops/tridiag.py`` and its Pallas kernel
``ops/pallas_tridiag.py::_thomas_kernel``.  ``solve`` dispatches on where
the right-hand side lives: a CPU tensor takes the plain PyTorch recurrence
(:func:`solve_scan`), a CUDA tensor launches the hand-written kernel
(:func:`thomas_solve`, ``csrc/tridiag.cu``).  There is no fallback between
the two.

The kernel is bound by device memory (one thread per column, every level's
load coalesced across a warp); its note in ``csrc/tridiag.cu`` says what the
design does about that.
"""

from __future__ import annotations

import math

import torch

from . import _cuda


def solve(dl, d, du, b):
    """Solve A x = b for each trailing-batch column.

    dl, d, du, b: [n, ...] sub-, main-, super-diagonal and RHS; dl[0] and
    du[n-1] are ignored.  Diagonals may carry broadcastable batch dims.
    Returns x with the broadcast shape."""
    if b.is_cuda:
        return thomas_solve(dl, d, du, b)
    return solve_scan(dl, d, du, b)


def solve_scan(dl, d, du, b):
    """Plain PyTorch Thomas recurrence (the kernel's reference version): the
    forward sweep then the back substitution, a Python loop over levels."""
    shape = torch.broadcast_shapes(dl.shape, d.shape, du.shape, b.shape)
    dl, d, du, b = (a.expand(shape) for a in (dl, d, du, b))
    n = shape[0]
    cp_prev = torch.zeros_like(b[0])
    dp_prev = torch.zeros_like(b[0])
    cps, dps = [], []
    for k in range(n):
        a = dl[k]
        denom = d[k] - a * cp_prev
        cp_prev = du[k] / denom
        dp_prev = (b[k] - a * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(b[0])
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        x_next = dps[k] - cps[k] * x_next
        xs[k] = x_next
    return torch.stack(xs)


def _column_count(a, shape) -> int:
    """Columns a broadcast diagonal really holds, when it varies only over a
    trailing block of the batch dims (leading batch dims of size 1); else 0."""
    if a.dim() != len(shape) or a.shape[0] != shape[0]:
        return 0
    batch = a.shape[1:]
    lead = 0
    while lead < len(batch) and batch[lead] == 1:
        lead += 1
    if tuple(batch[lead:]) != tuple(shape[1 + lead:]):
        return 0
    return math.prod(batch[lead:])


def thomas_solve(dl, d, du, b):
    """Launch the CUDA Thomas kernel on the current stream.

    All inputs float32 on one CUDA device.  The right-hand side must be
    contiguous with the full broadcast shape [n, ...]; each diagonal is
    either that shape or a contiguous broadcast over leading batch dims
    (e.g. [n, 1, ny, nx] against [n, L, ny, nx]), read by column modulus
    without a copy."""
    shape = torch.broadcast_shapes(dl.shape, d.shape, du.shape, b.shape)
    if tuple(b.shape) != tuple(shape):
        raise ValueError(f"thomas_solve: rhs {tuple(b.shape)} must have the "
                         f"broadcast shape {tuple(shape)}")
    n = shape[0]
    m = math.prod(shape[1:])
    dev = b.device
    cols = []
    for name, a in (("dl", dl), ("d", d), ("du", du), ("b", b)):
        if not a.is_cuda or a.device != dev:
            raise ValueError(f"thomas_solve: {name} must be on {dev}")
        if a.dtype != torch.float32:
            raise ValueError(f"thomas_solve: {name} must be float32")
        if not a.is_contiguous():
            raise ValueError(f"thomas_solve: {name} must be contiguous")
        mc = _column_count(a, shape)
        if mc == 0:
            raise ValueError(f"thomas_solve: {name} shape {tuple(a.shape)} "
                             f"does not broadcast by column over {tuple(shape)}")
        cols.append(mc)
    x = torch.empty(shape, dtype=torch.float32, device=dev)
    cp = torch.empty((n, m), dtype=torch.float32, device=dev)
    dp = torch.empty((n, m), dtype=torch.float32, device=dev)
    err = _cuda.lib().wpt_thomas_solve_f32(
        dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
        x.data_ptr(), cp.data_ptr(), dp.data_ptr(), n, m, *cols,
        _cuda.stream_ptr(dev))
    _cuda.check(err, "thomas_solve")
    thomas_solve.launches += 1
    thomas_solve.shapes.add(tuple(tuple(a.shape) for a in (dl, d, du, b)))
    return x


# launches: kernel launches; shapes: the argument shapes they were given,
# so a check can repeat them.  Both are read and reset by their caller.
thomas_solve.launches = 0
thomas_solve.shapes = set()
