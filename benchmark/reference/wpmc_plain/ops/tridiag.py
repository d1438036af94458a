"""Batched tridiagonal (Thomas) column solver, plain PyTorch: the port's
``ops/tridiag.py`` with the column kernel (K1) taken out, so every device
runs the recurrence of :func:`solve_scan` (field by field in
:func:`solve_fields_scan`).
"""

from __future__ import annotations

import torch


def solve(dl, d, du, b):
    """Solve A x = b for each trailing-batch column.

    dl, d, du, b: [n, ...] sub-, main-, super-diagonal and RHS; dl[0] and
    du[n-1] are ignored.  Diagonals may carry broadcastable batch dims.
    Returns x with the broadcast shape."""
    return solve_scan(dl, d, du, b)


def solve_fields(dl, d, du, fields):
    """Solve A x = f for every f in ``fields`` with one set of [n, *cols]
    coefficients; each f is [n, *cols] or [L, n, *cols] (L columns per
    coefficient column).  Returns the solutions in the fields' shapes."""
    return solve_fields_scan(dl, d, du, fields)


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


def solve_fields_scan(dl, d, du, fields):
    """Plain version of :func:`solve_fields`: :func:`solve_scan` field by
    field, an [L, n, *cols] field as [n, L, *cols] against coefficients
    broadcast over L (the same float32 operations per element)."""
    out = []
    for f in fields:
        if f.dim() == d.dim():
            out.append(solve_scan(dl, d, du, f))
        else:
            x = solve_scan(dl[:, None], d[:, None], du[:, None], f.transpose(0, 1))
            out.append(x.transpose(0, 1))
    return out
