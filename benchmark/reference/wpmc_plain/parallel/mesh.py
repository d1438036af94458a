"""The 2-D ('y', 'x') decomposition of the horizontal domain over ranks.

Port of ``wrf_partmc_tpu/parallel/mesh.py`` on ``torch.distributed``: one
process per device, rank r at mesh position (iy, ix) = divmod(r, px), the
row-major order of the JAX package's device mesh.  The vertical is never
decomposed.  A rank owns the block ``[:, iy*ny/py : (iy+1)*ny/py,
ix*nx/px : (ix+1)*nx/px]`` of every [nz, ny, nx, ...] cell field
(:func:`shard_field`); [ny, nx] fields are split on their two axes.
:func:`block_of` cuts a global Eulerian field, whose last two axes are
(y, x) whatever leads them (``[n_moist, nz, ny, nx]``, ``[nz+1, ny,
nx]``, ...), into this rank's block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.rng import Block


def factor_2d(n: int) -> tuple[int, int]:
    """The most square (py, px) with py * px = n and py <= px (the
    MPASPECT policy)."""
    best = (1, n)
    for py in range(1, int(math.isqrt(n)) + 1):
        if n % py == 0:
            best = (py, n // py)
    return best


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (py, px) mesh: its position (iy, ix), its
    device and its process group (None: the default group)."""

    shape: tuple[int, int]
    rank: int
    device: torch.device
    group: object = None

    @property
    def py(self) -> int:
        return self.shape[0]

    @property
    def px(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.py * self.px

    @property
    def iy(self) -> int:
        return self.rank // self.px

    @property
    def ix(self) -> int:
        return self.rank % self.px

    def rank_at(self, iy: int, ix: int) -> int:
        """Group rank of the mesh position (iy, ix), wrapped periodically."""
        return (iy % self.py) * self.px + ix % self.px

    def extent(self, axis: str) -> int:
        return self.py if axis == "y" else self.px

    def block_shape(self, ny: int, nx: int) -> tuple[int, int]:
        """(ny_l, nx_l) of every rank's block; raises unless the mesh
        divides the grid."""
        if ny % self.py or nx % self.px:
            raise ValueError(f"mesh {self.py}x{self.px} does not divide the "
                             f"{ny}x{nx} grid")
        return ny // self.py, nx // self.px

    def slices(self, ny: int, nx: int) -> tuple[slice, slice]:
        """(rows, columns) of this rank's block of an ny x nx grid."""
        ny_l, nx_l = self.block_shape(ny, nx)
        return (slice(self.iy * ny_l, (self.iy + 1) * ny_l),
                slice(self.ix * nx_l, (self.ix + 1) * nx_l))

    def draw_block(self, ny: int, nx: int) -> Block:
        """This rank's block of a global-shape random draw (``rng.Block``)."""
        ny_l, nx_l = self.block_shape(ny, nx)
        return Block(ny, nx, self.iy * ny_l, self.ix * nx_l, ny_l, nx_l)


def make_mesh(shape: tuple[int, int] | None = None, device=None, group=None) -> Mesh:
    """The mesh of the initialized process group (``factor_2d`` of its size
    by default) with this rank on ``device`` (default: the group's backend
    device, ``cuda:{rank % device_count}`` under NCCL, else the CPU).
    Raises when no process group is initialized, the shape does not match
    the group's size, or the device does not match the backend (a cuda
    mesh never runs over gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.init_from_env or init first")
    n = dist.get_world_size(group)
    shape = tuple(shape) if shape is not None else factor_2d(n)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    rank = dist.get_rank(group)
    nccl = dist.get_backend(group) == "nccl"
    if device is None:
        device = torch.device("cuda", rank % torch.cuda.device_count()) if nccl else "cpu"
    device = torch.device(device)
    if (device.type == "cuda") != nccl:
        raise ValueError(f"a {device.type} mesh cannot run on the "
                         f"{dist.get_backend(group)} backend (cuda takes NCCL, cpu gloo)")
    return Mesh(shape=shape, rank=rank, device=device, group=group)


def shard_field(x: torch.Tensor, mesh: Mesh | None, ny: int | None = None,
                nx: int | None = None) -> torch.Tensor:
    """This rank's block of a global cell field: axes 1, 2 of a
    [nz, ny, nx, ...] tensor, axes 0, 1 of a [ny, nx] one (the counterpart
    of the JAX package's ``field_sharding``).  ``ny``/``nx`` default to the
    tensor's own extents.  ``mesh=None`` returns ``x``."""
    if mesh is None:
        return x
    ay = 0 if x.dim() == 2 else 1
    ny = x.shape[ay] if ny is None else ny
    nx = x.shape[ay + 1] if nx is None else nx
    if (x.shape[ay], x.shape[ay + 1]) != (ny, nx):
        raise ValueError(f"shard_field: axes {ay}, {ay + 1} of {tuple(x.shape)} "
                         f"are not the {ny}x{nx} grid")
    ys, xs = mesh.slices(ny, nx)
    return x[(slice(None),) * ay + (ys, xs)]


def block_of(x: torch.Tensor, mesh: Mesh | None, ny: int, nx: int) -> torch.Tensor:
    """This rank's block of a global field whose last two axes are the
    ``ny`` x ``nx`` grid, as a contiguous tensor of its own (it keeps no
    reference to the global storage).  Raises unless the last two axes are
    the global grid, so a block is never cut twice.  ``mesh=None`` returns
    ``x``."""
    if mesh is None:
        return x
    if tuple(x.shape[-2:]) != (ny, nx):
        raise ValueError(f"block_of: the last two axes of {tuple(x.shape)} are not the "
                         f"{ny}x{nx} grid")
    ys, xs = mesh.slices(ny, nx)
    return x[..., ys, xs].clone(memory_format=torch.contiguous_format)
