"""Specified + relaxation lateral boundary conditions (the wrfbdy contract).

Port of ``wrf_partmc_tpu/models/coupled/bdy.py``: the outermost
``spec_zone`` points are set to the time-interpolated boundary value and the
next ``relax_zone`` points are relaxed toward it with weights decaying into
the interior, for u, v, theta', moisture, mu, ph and the chem tracers (not
the number tracers, which are re-derived from the particles every step).
The boundary time series is four edge slabs per variable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ...config import Config
from ...grid import Grid
from ..dycore.state import DycoreState

EDGES = ("xs", "xe", "ys", "ye")


@dataclass(frozen=True)
class BdyData:
    """Boundary time series.  ``slabs[name][edge]`` for each variable name
    ("u", "v", "theta_p", "moist", "mu", "ph", "chem"):

      xs: [T, *lead, nz, ny, W]   west   (x = 0..W-1)
      xe: [T, *lead, nz, ny, W]   east   (x = nx-W..nx-1)
      ys: [T, *lead, nz, W, nx]   south
      ye: [T, *lead, nz, W, nx]   north
    """

    times: torch.Tensor               # [T] seconds since run start
    slabs: dict

    @property
    def width(self) -> int:
        return next(iter(self.slabs.values()))["xs"].shape[-1]


def slabs_from_state(dyn: DycoreState, width: int, chem: bool = True):
    """Edge slabs of one state, with the mu and ph forcing that keeps mass
    from reflecting at the open boundary."""
    def four(f):
        return {"xs": f[..., :, :width], "xe": f[..., :, -width:],
                "ys": f[..., :width, :], "ye": f[..., -width:, :]}

    out = {"u": four(dyn.u), "v": four(dyn.v), "theta_p": four(dyn.theta_p),
           "moist": four(dyn.moist)}
    if dyn.mu is not None:
        out["mu"] = four(dyn.mu)
    if dyn.ph is not None:
        out["ph"] = four(dyn.ph)
    if chem and dyn.chem is not None:
        out["chem"] = four(dyn.chem)
    return out


def make_bdy(times, states, width: int = 5, chem: bool = True) -> BdyData:
    """A BdyData from a sequence of full states at ``times``."""
    slabs_t = [slabs_from_state(s, width, chem) for s in states]
    slabs = {n: {e: torch.stack([st[n][e] for st in slabs_t]) for e in EDGES}
             for n in slabs_t[0]}
    dev = states[0].u.device
    return BdyData(times=torch.as_tensor(np.asarray(times, np.float32), device=dev),
                   slabs=slabs)


def zone_weights(grid: Grid, cfg: Config, dt: float = 0.0):
    """[ny, nx] per-step blend weight toward the boundary value: 1 in the
    spec zone, Davies relaxation weights decaying across the relax zone,
    0 inside.  Built in float64 numpy on the global indices, as the
    reference, and cut to the block of a block ``grid``."""
    ns, nr = cfg.boundary.spec_zone, cfg.boundary.relax_zone
    W = ns + nr
    ny, nx = grid.global_shape
    ii = np.arange(nx)
    jj = np.arange(ny)
    dist = np.minimum.outer(np.minimum(jj, ny - 1 - jj),
                            np.minimum(ii, nx - 1 - ii))
    n = dist + 1
    in_spec = n <= ns
    in_relax = (n > ns) & (n <= W)
    frac = np.clip((W - n) / max(nr, 1), 0.0, 1.0)
    w_relax = 0.2 * frac * np.exp(-(n - ns - 1) / 2.0)
    w = np.where(in_spec, 1.0, np.where(in_relax, w_relax, 0.0))
    y0, x0 = grid.offsets
    w = w[y0:y0 + grid.ny, x0:x0 + grid.nx]
    return torch.as_tensor(np.ascontiguousarray(w, np.float32), device=grid.dz.device)


def _overlap(start: int, stop: int, b0: int, n: int):
    """(slab slice, field slice) of the global range [start, stop) that the
    block [b0, b0 + n) holds, or None."""
    lo, hi = max(start, b0), min(stop, b0 + n)
    if lo >= hi:
        return None
    return slice(lo - start, hi - start), slice(lo - b0, hi - b0)


def edge_sections(grid: Grid, width: int):
    """The parts of the four edge slabs that lie on ``grid`` (the whole
    domain, or a block of it), in paint order: (edge, slab index, field
    index), each index the (y, x) slices of the last two axes.  An edge
    slab's zone can reach past a block into the next, so each edge takes
    the intersection of its global rows and columns with the block's."""
    NY, NX = grid.global_shape
    y0, x0 = grid.offsets
    rows = _overlap(0, NY, y0, grid.ny)
    cols = _overlap(0, NX, x0, grid.nx)
    ranges = {"xs": (rows, _overlap(0, width, x0, grid.nx)),
              "xe": (rows, _overlap(NX - width, NX, x0, grid.nx)),
              "ys": (_overlap(0, width, y0, grid.ny), cols),
              "ye": (_overlap(NY - width, NY, y0, grid.ny), cols)}
    out = []
    for e in EDGES:
        ry, rx = ranges[e]
        if ry is not None and rx is not None:
            out.append((e, (ry[0], rx[0]), (ry[1], rx[1])))
    return out


def _interp_slabs(bdy: BdyData, name: str, t: float, sections):
    """The ``sections`` of the slabs of ``name`` linearly interpolated to
    time ``t``; the bracketing slabs are picked on the device (no host
    sync)."""
    sl = bdy.slabs[name]
    times = bdy.times
    T = times.shape[0]
    tt = torch.full((1,), t, dtype=torch.float32, device=times.device)
    i1 = torch.clamp(torch.searchsorted(times, tt, right=True), 1, T - 1)
    i0 = i1 - 1
    t0, t1 = times.index_select(0, i0), times.index_select(0, i1)
    f = torch.clamp((tt - t0) / torch.clamp(t1 - t0, min=1e-6), 0.0, 1.0)[0]
    out = []
    for e, s_idx, f_idx in sections:
        slab = sl[e][(Ellipsis, *s_idx)]
        out.append((f_idx, (1.0 - f) * slab.index_select(0, i0)[0]
                    + f * slab.index_select(0, i1)[0]))
    return out


def _target_field(field, painted):
    """A copy of ``field`` with the edge sections painted on in order;
    corners take the later (y) paint, where the weights are the same."""
    tgt = field.clone()
    for f_idx, values in painted:
        tgt[(Ellipsis, *f_idx)] = values
    return tgt


def apply_specified_relax(dyn: DycoreState, bdy: BdyData, t: float, grid: Grid,
                          cfg: Config, w2=None) -> DycoreState:
    """One post-step specified + relaxation blend of u/v/theta'/moist/mu/
    ph/chem.  ``w2``: the [ny, nx] zone weights (``zone_weights``), built
    here when not given.  On a block ``grid``, ``dyn`` is the block and
    only the slab sections on the block are painted."""
    if w2 is None:
        w2 = zone_weights(grid, cfg, cfg.dynamics.dt)
    sections = edge_sections(grid, bdy.width)

    def blend(field, name):
        tgt = _target_field(field, _interp_slabs(bdy, name, t, sections))
        return field + w2 * (tgt - field)

    upd = {n: blend(getattr(dyn, n), n) for n in ("u", "v", "theta_p", "moist")}
    for n in ("mu", "ph", "chem"):
        if n in bdy.slabs and getattr(dyn, n) is not None:
            upd[n] = blend(getattr(dyn, n), n)
    return dataclasses.replace(dyn, **upd)
