"""Neighbor-access primitives for finite-volume stencils.

Port of ``wrf_partmc_tpu/ops/stencil.py``.  Convention:
``shift(a, s, axis)[..., i] == a[..., i + s]``.

Inside :func:`decomposed` the fields are a rank's Eulerian blocks
``[..., ny_l, nx_l]`` of a domain split over a ('y', 'x') mesh, and a
shift or tap on the y or x axis takes its halo from the neighbouring
ranks (``parallel.halo.pad_axis``): across a rank edge the halo is the
neighbour's points, at a global edge it wraps (``bc="periodic"``) or
repeats the edge point (``"clamp"``), as the same call gives on the whole
domain.  This is the torch counterpart of the halo collective-permutes
that GSPMD puts in for the JAX package's rolls and slices.  The z axis
stays local.  Outside the context every access is local, as on one device.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from ..parallel import halo

AXIS_Z, AXIS_Y, AXIS_X = -3, -2, -1
BCS = ("periodic", "clamp")
MAX_HALO = 3        # the widest tap: WENO5 and the 5th/6th-order fluxes

# (mesh, ny_l, nx_l) while decomposed() is active in this context
_BLOCK = contextvars.ContextVar("stencil_block", default=None)


@contextlib.contextmanager
def decomposed(mesh, block_shape):
    """Make every y/x shift and tap a block stencil of ``mesh`` while the
    context is open: the tensors they take must be Eulerian blocks whose
    last two axes are ``block_shape`` (ny_l, nx_l), else they raise.
    ``mesh=None`` leaves (or makes) the accesses local.  Nests."""
    token = _BLOCK.set(None if mesh is None else (mesh, *block_shape))
    try:
        yield
    finally:
        _BLOCK.reset(token)


def on_grid(grid):
    """:func:`decomposed` for the blocks of ``grid`` (a ``Grid``; local when
    it is the whole domain)."""
    return decomposed(grid.mesh, (grid.ny, grid.nx))


def _mesh_axis(a, axis: int):
    """The mesh axis name ("y"/"x") of ``axis`` of ``a`` inside
    :func:`decomposed`, else None (local)."""
    block = _BLOCK.get()
    if block is None:
        return None
    d = axis % a.dim()
    if d < a.dim() - 2:
        return None
    _, ny_l, nx_l = block
    if tuple(a.shape[-2:]) != (ny_l, nx_l):
        raise ValueError(f"a horizontal stencil access on {tuple(a.shape)}, which is not an "
                         f"Eulerian block [..., {ny_l}, {nx_l}] of the decomposition")
    return "y" if d == a.dim() - 2 else "x"


def _check_bc(bc: str) -> None:
    if bc not in BCS:
        raise ValueError(f"unknown bc {bc!r}")


def _edge(a, start: int, reps: int, axis: int):
    e = a.narrow(axis, start, 1)
    shape = list(a.shape)
    shape[axis] = reps
    return e.expand(shape)


def shift(a, s: int, axis: int, bc: str = "periodic"):
    """Neighbor fetch: result[i] = a[i+s].  bc: 'periodic' | 'clamp'."""
    _check_bc(bc)
    if s == 0:
        return a
    name = _mesh_axis(a, axis)
    if name is not None:
        n = a.shape[axis]
        ext = halo.pad_axis(a, max(-s, 0), max(s, 0), axis, _BLOCK.get()[0], name,
                            periodic=bc == "periodic")
        return ext.narrow(axis, max(s, 0), n)
    if bc == "periodic":
        return torch.roll(a, -s, dims=axis)
    n = a.shape[axis]
    if s > 0:
        return torch.cat([a.narrow(axis, s, n - s),
                          _edge(a, n - 1, s, axis)], dim=axis)
    return torch.cat([_edge(a, 0, -s, axis), a.narrow(axis, 0, n + s)],
                     dim=axis)


def make_taps(a, lo: int, hi: int, axis: int, bc: str = "periodic"):
    """``tap(s)`` giving a[..., i+s] for s in [lo, hi], each a view into one
    halo-extended buffer."""
    _check_bc(bc)
    if lo == 0 and hi == 0:
        return lambda s: a
    n = a.shape[axis]
    name = _mesh_axis(a, axis)
    if name is not None:
        ext = halo.pad_axis(a, max(-lo, 0), max(hi, 0), axis, _BLOCK.get()[0], name,
                            periodic=bc == "periodic")
    else:
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


def diff_at_faces(a, axis: int, bc: str = "periodic"):
    """Face-centred difference: d[i] = a[i] - a[i-1] (at owner face i)."""
    return a - shift(a, -1, axis, bc)


def avg_to_faces(a, axis: int, bc: str = "periodic"):
    """Two-point average onto owner faces: f[i] = (a[i] + a[i-1]) / 2."""
    return 0.5 * (a + shift(a, -1, axis, bc))
