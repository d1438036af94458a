"""The transport's move draw, open-edge drop and class ranks (K6).

From each particle slot's two uniforms, its number and its weight class,
and its cell's face probabilities and cumulative vertical row, a move draw
gives each slot a destination class (``dcode``): the level of a vertical
mover, ``nz`` + W/E/S/N (0-3) for a horizontal one, :data:`STAY` for a live
slot that stays, :data:`GONE` for a dead slot or a mover across an open
edge.  The within-cell exclusive rank of each mover among the earlier
movers of its class (``rank_p``) and the count of each class (``cnt``)
follow from the codes.  These are the front of
``models/coupled/transport.py``'s rebucket.

A CPU tensor takes the plain PyTorch version, one full pass over the slots
for each class; a CUDA tensor launches the hand-written kernel
(``csrc/moves.cu``), one pass over the slots for all of it, with the same
float32 operations, so its codes, ranks and counts are bit-equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _cuda

STAY = -1      # a live slot that stays in its cell
GONE = -2      # a dead slot, or a mover across an open edge (dropped)
MAX_CLASSES = 1536     # D = nz + 4: the kernel's counters in 48 KB of shared memory


class Edges(NamedTuple):
    """Where a block of ``[nz, ny_l, nx_l]`` cells lies in the domain, for
    the open-edge drop: its first global row and column, the domain's rows
    and columns, and which axes are open."""
    iy0: int
    ix0: int
    ny: int
    nx: int
    open_y: bool
    open_x: bool


def _by_class(field_cf, w_class):
    """field_cf [n_class, nz, ny, nx] -> per-particle values [nz, ny, nx, P]
    (an exact gather by each particle's class)."""
    f = field_cf.movedim(0, -1)
    return torch.gather(f, -1, w_class.long())


def draw_moves(u, u2, w_class, ph, R_cum):
    """(dj, di, dest, horizontal), each [nz, ny, nx, P], from the uniforms
    ``u`` (the horizontal face) and ``u2`` (the new level): a particle first
    tries one face by the running sum of its class's four face
    probabilities ``ph``, otherwise takes the level where ``u2`` passes its
    column's cumulative R row (``R_cum`` [n_class, ny, nx, src, dst])."""
    nz = u.shape[0]
    pxm, pxp, pym, pyp = (_by_class(p, w_class) for p in ph)
    c1 = pxm
    c2 = c1 + pxp
    c3 = c2 + pym
    c4 = c3 + pyp
    di = torch.where(u < c1, -1, torch.where(u < c2, 1, 0))
    dj = torch.where((u >= c2) & (u < c3), -1,
                     torch.where((u >= c3) & (u < c4), 1, 0))
    horizontal = u < c4

    Rt = R_cum.permute(4, 0, 3, 1, 2)              # [dst, C, src, ny, nx]
    dest = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    for d in range(nz):
        dest += (u2 >= _by_class(Rt[d], w_class))
    return dj, di, torch.clamp(dest, 0, nz - 1), horizontal


def edge_drop(dj, di, horizontal, edges: Edges):
    """[nz, ny, nx, P] mask of horizontal movers whose global target cell
    lies outside the domain on an open axis."""
    _, nyl, nxl, _ = dj.shape
    drop = torch.zeros(dj.shape, dtype=torch.bool, device=dj.device)
    if edges.open_x:
        gi = edges.ix0 + torch.arange(nxl, device=dj.device).reshape(1, 1, nxl, 1) + di
        drop = drop | (horizontal & ((gi < 0) | (gi >= edges.nx)))
    if edges.open_y:
        gj = edges.iy0 + torch.arange(nyl, device=dj.device).reshape(1, nyl, 1, 1) + dj
        drop = drop | (horizontal & ((gj < 0) | (gj >= edges.ny)))
    return drop


def move_codes(alive, dest, dj, di, horizontal, drop):
    """[C, P] int32 destination class of each slot (``dcode``, module
    docstring) from the move draw, each input [nz, ny, nx, P]."""
    nz, P = dest.shape[0], dest.shape[-1]
    kk = torch.arange(nz, device=dest.device).reshape(nz, 1, 1, 1)
    vert = (~horizontal) & (dest != kk)
    hdir = torch.where(di < 0, 0, torch.where(di > 0, 1, torch.where(dj < 0, 2, 3)))
    code = torch.where(vert, dest, torch.where(horizontal, nz + hdir, STAY))
    return torch.where(alive & ~drop, code, GONE).to(torch.int32).reshape(-1, P)


def class_ranks(dcode, D: int):
    """(rank_p [C, P] int32, cnt [C, D] float32): each mover's rank among
    the earlier slots of its cell with its class (an exclusive cumsum per
    class; 0 where ``dcode`` < 0) and each class's count."""
    rank_p = torch.zeros(dcode.shape, dtype=torch.int64, device=dcode.device)
    cnt = []
    for d in range(D):
        m = dcode == d
        rank_p = torch.where(m, torch.cumsum(m, dim=-1) - 1, rank_p)
        cnt.append(torch.sum(m, dim=-1, dtype=torch.float32))
    return rank_p.to(torch.int32), torch.stack(cnt, dim=-1)


def move_ranks_plain(u, u2, num, w_class, ph, R_cum, edges: Edges):
    """(dcode, rank_p, cnt) by the plain chain: the draw, the drop, the
    codes and the per-class ranks."""
    dj, di, dest, horizontal = draw_moves(u, u2, w_class, ph, R_cum)
    drop = edge_drop(dj, di, horizontal, edges)
    dcode = move_codes(num > 0.0, dest, dj, di, horizontal, drop)
    return (dcode, *class_ranks(dcode, u.shape[0] + 4))


def _check(u, u2, num, w_class, ph, R_cum):
    dev = u.device
    tensors = (u, u2, num, w_class, *ph, R_cum)
    if not (u.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("move_ranks: every input must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in (u, u2, num, *ph, R_cum)) \
            or w_class.dtype != torch.int32:
        raise ValueError("move_ranks: needs float32 uniforms, numbers, probabilities and "
                         f"R rows and int32 classes, got {[t.dtype for t in tensors]}")
    if u.dim() != 4 or any(t.shape != u.shape for t in (u2, num, w_class)):
        raise ValueError("move_ranks: the slot inputs must share one [nz, ny, nx, P] shape, "
                         f"got {[tuple(t.shape) for t in (u, u2, num, w_class)]}")
    nz, ny, nx, _ = u.shape
    n_class = ph[0].shape[0] if ph[0].dim() == 4 else 0
    if len(ph) != 4 or n_class < 1 or any(p.shape != (n_class, nz, ny, nx) for p in ph) \
            or R_cum.shape != (n_class, ny, nx, nz, nz):
        raise ValueError("move_ranks: needs four [n_class, nz, ny, nx] face probabilities and "
                         f"[n_class, ny, nx, nz, nz] R rows, got "
                         f"{[tuple(p.shape) for p in ph]} / {tuple(R_cum.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("move_ranks: every input must be contiguous")
    if nz + 4 > MAX_CLASSES:
        raise ValueError(f"move_ranks: {nz} levels exceed the kernel's {MAX_CLASSES} classes")
    # the kernel's 1-D grid holds eight cells a block
    if nz * ny * nx > 8 * (2**31 - 1):
        raise ValueError("move_ranks: too many cells for the launch grid")


def move_ranks_cuda(u, u2, num, w_class, ph, R_cum, edges: Edges):
    """Launch K6 on the current stream: (dcode, rank_p, cnt)."""
    _check(u, u2, num, w_class, ph, R_cum)
    nz, ny, nx, P = u.shape
    C, D = nz * ny * nx, nz + 4
    dcode = torch.empty((C, P), dtype=torch.int32, device=u.device)
    rank_p = torch.empty((C, P), dtype=torch.int32, device=u.device)
    cnt = torch.empty((C, D), dtype=torch.float32, device=u.device)
    err = _cuda.lib().wpt_move_ranks(
        u.data_ptr(), u2.data_ptr(), num.data_ptr(), w_class.data_ptr(),
        *(p.data_ptr() for p in ph), R_cum.data_ptr(),
        dcode.data_ptr(), rank_p.data_ptr(), cnt.data_ptr(),
        C, ph[0].shape[0], nz, ny, nx, P,
        int(edges.iy0), int(edges.ix0), int(edges.ny), int(edges.nx),
        int(edges.open_y), int(edges.open_x), _cuda.stream_ptr(u.device))
    _cuda.check(err, "move_ranks")
    move_ranks_cuda.launches += 1
    move_ranks_cuda.shapes.add((ph[0].shape[0], tuple(u.shape), tuple(edges)))
    return dcode, rank_p, cnt


# launches: kernel launches; shapes: (n_class, slot shape, edges) of each,
# so a check can repeat them.  Both are read and reset by their caller.
move_ranks_cuda.launches = 0
move_ranks_cuda.shapes = set()


def move_ranks(u, u2, num, w_class, ph, R_cum, edges: Edges):
    """(dcode [C, P] int32, rank_p [C, P] int32, cnt [C, D] float32) of the
    slots [nz, ny, nx, P]: ``u``/``u2`` the move draw's uniforms, ``num``
    the numbers (alive where > 0), ``w_class`` the int32 weight classes,
    ``ph`` the four face probabilities [n_class, nz, ny, nx], ``R_cum`` the
    cumulative R rows [n_class, ny, nx, src, dst], ``edges`` the block's
    place for the open-edge drop."""
    if u.is_cuda:
        return move_ranks_cuda(u, u2, num, w_class, ph, R_cum, edges)
    return move_ranks_plain(u, u2, num, w_class, ph, R_cum, edges)
