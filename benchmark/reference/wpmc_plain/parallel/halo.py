"""Halo exchanges and the collectives of the decomposed step.

Port of ``wrf_partmc_tpu/parallel/halo.py`` on ``torch.distributed``: the
``lax.ppermute`` of the JAX package becomes point-to-point sends and
receives posted together (``batch_isend_irecv``).  Every rank posts the
same exchanges in the same order, so edge ranks of an open domain send
too (their halos are then clamp-filled).  A mesh axis of extent 1 is a
local copy with no collective: what a ppermute to self gives, and torch
refuses a send to its own rank.

The stencils of a decomposed Eulerian block take their horizontal
neighbours through :func:`pad_axis` (``ops.stencil.shift`` and
``make_taps`` call it while a decomposition is active): a one- or
two-sided halo of the widths the stencil reaches, one batch of sends and
receives a call, as each of GSPMD's collective-permutes is one.

Every call adds to :data:`COUNTS`: calls, bytes and the largest single
call's bytes for each kind (``halo``: every :func:`pad_axis` call with the
bytes of the halo it fills, local copies on an extent-1 axis included;
``p2p``: bytes sent; ``all_gather``: bytes of the gathered result;
``all_reduce``: bytes reduced).
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist

from .mesh import Mesh

KINDS = ("halo", "p2p", "all_gather", "all_reduce")
COUNTS = {k: {"calls": 0, "bytes": 0, "max_bytes": 0} for k in KINDS}

_TAG_UP, _TAG_DOWN = 1, 2    # data moving to the +1 / -1 neighbour


def reset_counts() -> None:
    for rec in COUNTS.values():
        rec.update(calls=0, bytes=0, max_bytes=0)


def read_counts() -> dict:
    """A copy of :data:`COUNTS`."""
    return copy.deepcopy(COUNTS)


def _count(kind: str, n_bytes: int) -> None:
    rec = COUNTS[kind]
    rec["calls"] += 1
    rec["bytes"] += n_bytes
    rec["max_bytes"] = max(rec["max_bytes"], n_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _global_rank(mesh: Mesh, r: int) -> int:
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def _p2p(mesh: Mesh, sends, recvs) -> None:
    """Post the (tensor, group rank, tag) sends and receives together and
    wait for all of them."""
    ops = [dist.P2POp(dist.isend, t, _global_rank(mesh, r), mesh.group, tag)
           for t, r, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, _global_rank(mesh, r), mesh.group, tag)
            for t, r, tag in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for t, _, _ in sends:
        _count("p2p", _nbytes(t))


def _index(mesh: Mesh, axis_name: str) -> int:
    return mesh.iy if axis_name == "y" else mesh.ix


def _neighbour(mesh: Mesh, axis_name: str, step: int) -> int:
    if axis_name == "y":
        return mesh.rank_at(mesh.iy + step, mesh.ix)
    return mesh.rank_at(mesh.iy, mesh.ix + step)


def _clamp_face(x, h: int, axis: int, lo: bool):
    """The edge slice of ``x`` repeated ``h`` times along ``axis`` (the
    fill of a halo at an open global boundary)."""
    edge = x.narrow(axis, 0 if lo else x.shape[axis] - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = h
    return edge.repeat(reps)


def pad_axis(x: torch.Tensor, lo: int, hi: int, axis: int, mesh: Mesh, axis_name: str,
             periodic: bool = True) -> torch.Tensor:
    """The local block ``x`` with ``lo`` halo points before and ``hi`` after
    it on ``axis``: the last ``lo`` points of the rank at -1 and the first
    ``hi`` of the rank at +1 along mesh axis ``axis_name`` ("y" or "x"),
    wrapped around the mesh.  With ``periodic`` False the halos at the
    global edges are clamp-filled (the edge point repeated), as
    ``stencil.shift(bc="clamp")`` fills them on the whole domain.  On an
    extent-1 axis the halo is a local copy (the block's own far faces: what
    ``torch.roll`` reads).  Raises when a halo is wider than the block."""
    axis %= x.dim()
    size = x.shape[axis]
    if lo == hi == 0:
        return x
    if lo < 0 or hi < 0:
        raise ValueError(f"halo widths ({lo}, {hi}) must be >= 0")
    if max(lo, hi) > size:
        raise ValueError(f"halo width {max(lo, hi)} > the block's extent {size} on mesh "
                         f"axis {axis_name!r}: use fewer ranks on that axis")
    up = x.narrow(axis, size - lo, lo).contiguous()      # my +1 neighbour's lo halo
    down = x.narrow(axis, 0, hi).contiguous()            # my -1 neighbour's hi halo
    n = mesh.extent(axis_name)
    if n == 1:
        lo_halo, hi_halo = up, down
    else:
        lo_halo, hi_halo = torch.empty_like(up), torch.empty_like(down)
        minus, plus = _neighbour(mesh, axis_name, -1), _neighbour(mesh, axis_name, 1)
        sends, recvs = [], []
        if lo:
            sends.append((up, plus, _TAG_UP))
            recvs.append((lo_halo, minus, _TAG_UP))
        if hi:
            sends.append((down, minus, _TAG_DOWN))
            recvs.append((hi_halo, plus, _TAG_DOWN))
        _p2p(mesh, sends, recvs)
    if not periodic:
        idx = _index(mesh, axis_name)
        if idx == 0 and lo:
            lo_halo = _clamp_face(x, lo, axis, lo=True)
        if idx == n - 1 and hi:
            hi_halo = _clamp_face(x, hi, axis, lo=False)
    _count("halo", _nbytes(lo_halo) + _nbytes(hi_halo))
    parts = ([lo_halo] if lo else []) + [x] + ([hi_halo] if hi else [])
    return torch.cat(parts, dim=axis)


def exchange_axis(x: torch.Tensor, h: int, axis: int, mesh: Mesh, axis_name: str,
                  periodic: bool = True) -> torch.Tensor:
    """Pad the local block ``x`` with ``h`` halo points on both sides of
    ``axis`` (:func:`pad_axis`).  Returns ``x`` with ``axis`` extended by
    2 h."""
    return pad_axis(x, h, h, axis, mesh, axis_name, periodic)


def exchange_2d(x: torch.Tensor, h: int, mesh: Mesh, periodic=(True, True),
                axes=(-2, -1)) -> torch.Tensor:
    """Halo-pad the (y, x) axes ``axes`` of a local block, y first and then
    x, so the corner halos come right."""
    x = exchange_axis(x, h, axes[0], mesh, "y", periodic[0])
    return exchange_axis(x, h, axes[1], mesh, "x", periodic[1])


def neighbor_shift(x: torch.Tensor, shift: int, mesh: Mesh, axis_name: str,
                   periodic: bool = True) -> torch.Tensor:
    """The whole block moved ``shift`` ranks along ``axis_name``: rank i's
    ``x`` arrives at rank i + shift (wrapped when ``periodic``).  A rank
    that nothing reaches (an open edge) gets zeros."""
    n = mesh.extent(axis_name)
    idx = _index(mesh, axis_name)
    dst, src = idx + shift, idx - shift
    if periodic:
        if shift % n == 0:
            return x.clone()
        dst, src = dst % n, src % n
    x = x.contiguous()
    out = torch.zeros_like(x)
    step = lambda j: _neighbour(mesh, axis_name, j - idx)
    sends = [(x, step(dst), _TAG_UP)] if 0 <= dst < n else []
    recvs = [(out, step(src), _TAG_UP)] if 0 <= src < n else []
    if sends or recvs:
        _p2p(mesh, sends, recvs)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[mesh.size, *x.shape]: every rank's ``x``, in rank order (gathered
    flat, the one form both gloo and NCCL take)."""
    flat = x.contiguous().reshape(-1)
    out = torch.empty(mesh.size * flat.numel(), dtype=x.dtype, device=x.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, flat, group=mesh.group)
    _count("all_gather", _nbytes(out))
    return out.reshape(mesh.size, *x.shape)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor)."""
    y = x.clone().contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    _count("all_reduce", _nbytes(y))
    return y
