"""Neighbor-access primitives for finite-volume stencils.

Port of ``wrf_partmc_tpu/ops/stencil.py``.  Convention:
``shift(a, s, axis)[..., i] == a[..., i + s]``.
"""

from __future__ import annotations

import torch

AXIS_Z, AXIS_Y, AXIS_X = -3, -2, -1


def _edge(a, start: int, reps: int, axis: int):
    e = a.narrow(axis, start, 1)
    shape = list(a.shape)
    shape[axis] = reps
    return e.expand(shape)


def shift(a, s: int, axis: int, bc: str = "periodic"):
    """Neighbor fetch: result[i] = a[i+s].  bc: 'periodic' | 'clamp'."""
    if s == 0:
        return a
    if bc == "periodic":
        return torch.roll(a, -s, dims=axis)
    if bc == "clamp":
        n = a.shape[axis]
        if s > 0:
            return torch.cat([a.narrow(axis, s, n - s),
                              _edge(a, n - 1, s, axis)], dim=axis)
        return torch.cat([_edge(a, 0, -s, axis), a.narrow(axis, 0, n + s)],
                         dim=axis)
    raise ValueError(f"unknown bc {bc!r}")


def make_taps(a, lo: int, hi: int, axis: int, bc: str = "periodic"):
    """``tap(s)`` giving a[..., i+s] for s in [lo, hi], each a view into one
    halo-extended buffer."""
    if lo == 0 and hi == 0:
        return lambda s: a
    n = a.shape[axis]
    parts = []
    if lo < 0:
        parts.append(a.narrow(axis, n + lo, -lo) if bc == "periodic"
                     else _edge(a, 0, -lo, axis))
    parts.append(a)
    if hi > 0:
        parts.append(a.narrow(axis, 0, hi) if bc == "periodic"
                     else _edge(a, n - 1, hi, axis))
    ext = torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]

    def tap(s: int):
        if s < lo or s > hi:
            raise ValueError(f"tap {s} outside [{lo}, {hi}]")
        return ext.narrow(axis, s - lo, n)

    return tap
