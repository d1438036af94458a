"""Arakawa C-grid geometry and hydrostatic base state.

Port of ``wrf_partmc_tpu/grid.py``: the same conventions (fields are
``[nz, ny, nx]``, owner-face staggering, eta = 1 at the surface) and the
same float64 numpy construction, stored as float32 tensors on ``device``.

A decomposed rank holds a block ``Grid`` (:func:`block_grid`): ``ny``/``nx``
are its block's extents, the [ny, nx] and [nz(+1), ny, nx] metric fields
its slices, and ``mesh``/``global_ny``/``global_nx`` place it in the
domain.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from . import constants as c
from .config import Config
from .ops.stencil import MAX_HALO
from .parallel.mesh import Mesh, block_of


@dataclass(frozen=True)
class Grid:
    """Static geometry + base state (all entries are constants of a run)."""

    eta_full: torch.Tensor      # [nz+1] full (w) levels, eta_full[0]=1 surface
    eta_half: torch.Tensor      # [nz]   half (mass) levels
    deta: torch.Tensor          # [nz]   layer thickness in eta (positive)
    mu_base: torch.Tensor       # []     base dry column mass [Pa]
    p_base: torch.Tensor        # [nz]   base-state dry pressure at half levels [Pa]
    alpha_base: torch.Tensor    # [nz]   base-state specific volume [m3 kg-1]
    t_base: torch.Tensor        # [nz]   base potential temperature
    z_half: torch.Tensor        # [nz]   base height of mass levels [m]
    z_full: torch.Tensor        # [nz+1] base height of w levels [m]
    dz: torch.Tensor            # [nz]   base layer depth [m]
    hgt: torch.Tensor           # [ny, nx] terrain height [m]
    mub: torch.Tensor           # [ny, nx] base dry column mass [Pa]
    phb: torch.Tensor           # [nz+1, ny, nx] base geopotential [m2 s-2]
    pb3: torch.Tensor           # [nz, ny, nx] base dry pressure [Pa]
    alb: torch.Tensor           # [nz, ny, nx] base specific volume
    msft: torch.Tensor          # [ny, nx] map factor at mass points
    f_cor: torch.Tensor         # [ny, nx] Coriolis parameter [s-1]
    rdx: float = 0.0
    rdy: float = 0.0
    # z_full[-1] as a host number, read once when the grid is built, so the
    # step reads the model top without a device-to-host copy
    ztop: float | None = None
    dx: float = 0.0
    dy: float = 0.0
    nx: int = 0
    ny: int = 0
    nz: int = 0
    # the decomposition of a block grid (None: the whole domain) and the
    # domain's extents (0: the grid's own)
    mesh: Mesh | None = None
    global_ny: int = 0
    global_nx: int = 0

    def __post_init__(self):
        if self.ztop is None:
            object.__setattr__(self, "ztop", float(self.z_full[-1]))

    @property
    def cell_volume(self) -> torch.Tensor:
        """[nz] base-state grid-cell volume [m3]."""
        return self.dx * self.dy * self.dz

    @property
    def global_shape(self) -> tuple[int, int]:
        """(ny, nx) of the whole domain."""
        return self.global_ny or self.ny, self.global_nx or self.nx

    @property
    def offsets(self) -> tuple[int, int]:
        """(y0, x0): the global index of the block's first row and column."""
        if self.mesh is None:
            return 0, 0
        ys, xs = self.mesh.slices(*self.global_shape)
        return ys.start, xs.start


# the fields of a Grid that lie on the horizontal grid
HORIZONTAL_FIELDS = ("hgt", "mub", "phb", "pb3", "alb", "msft", "f_cor")


def block_grid(grid: Grid, mesh: Mesh | None, min_extent: int = MAX_HALO) -> Grid:
    """This rank's block of the whole-domain ``grid``: ``ny``/``nx`` the
    block's extents, the horizontal metric fields their block.  Raises
    when ``grid`` is a block already, when the mesh does not divide the
    grid, or when a split axis leaves a block narrower than
    ``min_extent`` (the widest stencil halo).  ``mesh=None`` returns
    ``grid``."""
    if mesh is None:
        return grid
    if grid.mesh is not None:
        raise ValueError("block_grid: the grid is a block already")
    ny_l, nx_l = mesh.block_shape(grid.ny, grid.nx)
    for name, n, extent in (("y", ny_l, mesh.py), ("x", nx_l, mesh.px)):
        if extent > 1 and n < min_extent:
            raise ValueError(f"block_grid: a {n}-point block on mesh axis {name!r} is "
                             f"narrower than the {min_extent}-point stencil halo")
    blocks = {f: block_of(getattr(grid, f), mesh, grid.ny, grid.nx)
              for f in HORIZONTAL_FIELDS}
    return dataclasses.replace(grid, **blocks, ny=ny_l, nx=nx_l, mesh=mesh,
                               global_ny=grid.ny, global_nx=grid.nx)


def make_grid(cfg: Config, device="cpu", hgt=None, f_cor: float = 0.0,
              msft=None) -> Grid:
    """Grid + isentropic (constant theta = T0) hydrostatic base state, built
    exactly as ``wrf_partmc_tpu.grid.make_grid`` (float64 numpy, then f32)."""
    d = cfg.domain
    nz = d.nz
    eta_full = np.linspace(1.0, 0.0, nz + 1)
    eta_half = 0.5 * (eta_full[:-1] + eta_full[1:])
    deta = eta_full[:-1] - eta_full[1:]

    p_surf = 1.0e5
    t_top = c.T0 - c.GRAV * d.ztop / c.CP
    if t_top <= 0:
        raise ValueError(f"ztop={d.ztop} too deep for isentropic base state")
    p_top = c.P0 * (t_top / c.T0) ** (c.CP / c.R_D)
    mu = p_surf - p_top

    p_half = p_top + mu * eta_half
    alpha_of_p = lambda p: c.R_D * c.T0 / c.P0 * (p / c.P0) ** (-c.CV / c.CP)
    alpha = alpha_of_p(p_half)

    phi_full = np.zeros(nz + 1)
    for k in range(nz):
        phi_full[k + 1] = phi_full[k] + mu * alpha[k] * deta[k]
    z_full = phi_full / c.GRAV
    z_half = 0.5 * (z_full[:-1] + z_full[1:])
    dz = np.diff(z_full)

    if hgt is None:
        h2 = np.zeros((d.ny, d.nx))
    else:
        h2 = np.asarray(hgt, dtype=np.float64)
        if h2.shape != (d.ny, d.nx):
            raise ValueError(f"hgt shape {h2.shape} != {(d.ny, d.nx)}")
    t_sfc = c.T0 - c.GRAV * h2 / c.CP
    if np.any(t_sfc <= 0):
        raise ValueError("terrain too high for isentropic base state")
    p_sfc = c.P0 * (t_sfc / c.T0) ** (c.CP / c.R_D)
    mub = p_sfc - p_top
    pb3 = p_top + mub[None] * eta_half[:, None, None]
    alb = alpha_of_p(pb3)
    phb = np.zeros((nz + 1, d.ny, d.nx))
    phb[0] = c.GRAV * h2
    for k in range(nz):
        phb[k + 1] = phb[k] + mub * alb[k] * deta[k]

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Grid(
        eta_full=f32(eta_full), eta_half=f32(eta_half), deta=f32(deta),
        mu_base=f32(mu), p_base=f32(p_half), alpha_base=f32(alpha),
        t_base=f32(np.full(nz, c.T0)), z_half=f32(z_half), z_full=f32(z_full),
        dz=f32(dz),
        hgt=f32(h2), mub=f32(mub), phb=f32(phb), pb3=f32(pb3), alb=f32(alb),
        msft=f32(np.ones((d.ny, d.nx)) if msft is None else np.asarray(msft)),
        f_cor=f32(np.full((d.ny, d.nx), f_cor)),
        rdx=1.0 / d.dx, rdy=1.0 / d.dy, dx=d.dx, dy=d.dy,
        nx=d.nx, ny=d.ny, nz=nz,
    )

