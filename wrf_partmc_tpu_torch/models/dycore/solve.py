"""The dycore timestep: the dispatcher, the linear core and the helpers
the ARW core shares.

Port of ``wrf_partmc_tpu/models/dycore/solve.py``: :class:`StepDiag`, the
horizontal Smagorinsky closure, the prognostic subgrid TKE (km_opt=2: N^2,
the eddy coefficients and the TKE advance), and the linear core that
``solve_step`` runs when ``dyn_opt != "arw"`` or the state has no ``mu``:
flat terrain, a quasi-compressible linearized pressure equation
dp'/dtau = -rho_b c_s^2 div(v), RK3 stages (``dyn_step``) of split-explicit
acoustic substeps with forward-backward horizontal momentum and a
vertically implicit w-p column solve (``_acoustic_integrate``, through
``ops/tridiag.solve``: kernel K1 on the card), then RK3 scalar advection
with per-class flux capture.  ``constant_velocity`` freezes the dynamics.

On the card ``solve_step`` replays a CUDA graph of the step: a whole-domain
CUDA state runs eagerly on its first call for a key (shapes, strides,
``Config``, device, the grid's buffers), is captured on its second and
replayed from then on; every other call runs eagerly.  ``GRAPH_COUNTS``
counts the three.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass

import torch

from ... import constants as c
from ...config import Config
from ...grid import Grid
from ...ops.advection import (OutflowProbs, face_fluxes, flux_divergence,
                              rk3_advect_mono, rk3_advect_pd)
from ...ops.stencil import AXIS_X, AXIS_Y, on_grid, shift
from ...ops.tridiag import solve as tridiag_solve
from ...utils.tree import tree_map
from ..physics.microphysics import kessler_step, wsm5_step
from ..physics.morrison import morrison_step
from .state import DycoreState, base_profiles, replace


@dataclass(frozen=True)
class StepDiag:
    """Per-step diagnostics consumed by the particle transport."""

    probs: OutflowProbs      # per-class outflow probabilities [n_class, ...]
    xkhh: torch.Tensor       # horizontal eddy diffusivity [nz, ny, nx]
    rho_u: torch.Tensor      # time-averaged mass-flux winds
    rho_v: torch.Tensor
    rho_w: torch.Tensor


def bc_pair(cfg: Config):
    bx = "periodic" if cfg.boundary.periodic_x else "clamp"
    by = "periodic" if cfg.boundary.periodic_y else "clamp"
    return bx, by


def laplacian_h(f, rdx, rdy, bc_x, bc_y):
    return ((shift(f, 1, AXIS_X, bc_x) - 2 * f + shift(f, -1, AXIS_X, bc_x)) * rdx ** 2
            + (shift(f, 1, AXIS_Y, bc_y) - 2 * f + shift(f, -1, AXIS_Y, bc_y)) * rdy ** 2)


def deformation_mag(state: DycoreState, grid: Grid, cfg: Config):
    """Horizontal deformation magnitude |D| at cell centers."""
    bx, by = bc_pair(cfg)
    rdx, rdy = grid.rdx, grid.rdy
    u_c = 0.5 * (state.u + shift(state.u, 1, AXIS_X, bx))
    v_c = 0.5 * (state.v + shift(state.v, 1, AXIS_Y, by))
    d11 = (shift(state.u, 1, AXIS_X, bx) - state.u) * rdx
    d22 = (shift(state.v, 1, AXIS_Y, by) - state.v) * rdy
    dudy = (shift(u_c, 1, AXIS_Y, by) - shift(u_c, -1, AXIS_Y, by)) * 0.5 * rdy
    dvdx = (shift(v_c, 1, AXIS_X, bx) - shift(v_c, -1, AXIS_X, bx)) * 0.5 * rdx
    d12 = 0.5 * (dudy + dvdx)
    return torch.sqrt(d11 ** 2 + d22 ** 2 + 2.0 * d12 ** 2)


def smagorinsky_khh(state: DycoreState, grid: Grid, cfg: Config):
    """2-D Smagorinsky closure (km_opt=4): K = (c_s dx)^2 |D|."""
    return (cfg.dynamics.smag_cs * grid.dx) ** 2 * deformation_mag(state, grid, cfg)


def _rho_faces(rho_b):
    """Base density at w levels [nz+1] (edge-extrapolated)."""
    mid = 0.5 * (rho_b[1:] + rho_b[:-1])
    return torch.cat([rho_b[:1], mid, rho_b[-1:]])


def _advective_tendency(f, mfx, mfy, mfz, rho_col, rdx, rdy, rdz, h_order,
                        v_order, bc_x, bc_y):
    """Advective-form tendency -v.grad(f), as the flux form minus f times
    the mass divergence."""
    fx, fy, fz = face_fluxes(f, mfx, mfy, mfz, h_order, v_order, bc_x, bc_y)
    div_f = flux_divergence(fx, fy, fz, rdx, rdy, rdz)
    div_m = ((shift(mfx, 1, AXIS_X, bc_x) - mfx) * rdx
             + (shift(mfy, 1, AXIS_Y, bc_y) - mfy) * rdy
             + (mfz[..., 1:, :, :] - mfz[..., :-1, :, :]) * rdz.reshape(-1, 1, 1))
    return -(div_f - f * div_m) / rho_col


def brunt_vaisala_sq(state: DycoreState, grid: Grid):
    """Moist-free N^2 = (g/theta) dtheta/dz at cell centers [nz, ny, nx]."""
    _, theta_b, _ = base_profiles(grid)
    th = theta_b.reshape(-1, 1, 1) + state.theta_p
    zh = grid.z_half
    # spacing matched to the dth stencil: one-sided ends, centered interior
    dz_f = torch.cat([zh[1:2] - zh[0:1], 0.5 * (zh[2:] - zh[:-2]),
                      zh[-1:] - zh[-2:-1]])
    dth = torch.cat([th[1:2] - th[0:1], 0.5 * (th[2:] - th[:-2]),
                     th[-1:] - th[-2:-1]], dim=0)
    dthdz = dth / dz_f.reshape(-1, 1, 1)
    return (c.GRAV / th) * dthdz


def tke_eddy_coeffs(state: DycoreState, grid: Grid, cfg: Config):
    """Eddy viscosities of the 1.5-order TKE closure (km_opt=2):
    K_m = 0.1 l sqrt(e) with l = min(Delta, 0.76 sqrt(e/N^2)),
    K_h = (1 + 2 l / Delta) K_m.  Returns (km, kh, length, delta)."""
    e = torch.clamp(state.tke, min=cfg.dynamics.tke_seed)
    delta = (grid.dx * grid.dy * grid.dz.mean()) ** (1.0 / 3.0)
    n2 = brunt_vaisala_sq(state, grid)
    l_stable = 0.76 * torch.sqrt(e / torch.clamp(n2, min=1e-10))
    length = torch.where(n2 > 1e-10, torch.minimum(delta, l_stable), delta)
    km = 0.10 * length * torch.sqrt(e)
    kh = (1.0 + 2.0 * length / delta) * km
    return km, kh, length, delta


def tke_advance(state: DycoreState, grid: Grid, cfg: Config, dt: float):
    """One forward step of de/dt = -v.grad(e) + K_m |D|^2 - K_h N^2
    - C_eps e^(3/2)/l + 2 K_m lap_h(e), e floored at tke_seed.  Returns
    (e_new, kh)."""
    bx, by = bc_pair(cfg)
    rho_b, _, _ = base_profiles(grid)
    rho_c = rho_b.reshape(-1, 1, 1)
    rho_f = _rho_faces(rho_b)
    rdz = 1.0 / grid.dz
    km, kh, length, delta = tke_eddy_coeffs(state, grid, cfg)
    adv = _advective_tendency(state.tke, rho_c * state.u, rho_c * state.v,
                              rho_f.reshape(-1, 1, 1) * state.w, rho_c,
                              grid.rdx, grid.rdy, rdz, 2, 2, bx, by)
    p_shear = km * deformation_mag(state, grid, cfg) ** 2
    p_buoy = -kh * brunt_vaisala_sq(state, grid)
    c_eps = 1.9 * (0.93 + 0.07 * length / delta)
    e = torch.clamp(state.tke, min=0.0)
    diss = c_eps * e ** 1.5 / torch.clamp(length, min=1e-3)
    diff = 2.0 * km * laplacian_h(e, grid.rdx, grid.rdy, bx, by)
    e_new = e + dt * (adv + p_shear + p_buoy - diss + diff)
    return torch.clamp(e_new, min=cfg.dynamics.tke_seed), kh


def horizontal_k(state: DycoreState, grid: Grid, cfg: Config):
    """Eddy diffusivity of the slow-variable mixing: khdif (diff_opt=1),
    the TKE closure's K_h (diff_opt=2, km_opt=2) or Smagorinsky."""
    dyn = cfg.dynamics
    if dyn.diff_opt == 1:
        return dyn.khdif
    if dyn.km_opt == 2:
        return tke_eddy_coeffs(state, grid, cfg)[1]
    return smagorinsky_khh(state, grid, cfg)


@dataclass(frozen=True)
class _SlowTend:
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    theta: torch.Tensor


def _w_levels(f):
    """Cell-centre field [nz, ...] -> w levels [nz+1, ...] (edge copies)."""
    return torch.cat([f[:1], 0.5 * (f[1:] + f[:-1]), f[-1:]], dim=0)


def _slow_tendencies(s: DycoreState, grid: Grid, cfg: Config) -> _SlowTend:
    """Advection and mixing tendencies of u, v, w and theta' at the RK stage
    state (the linear core's rk_tendency)."""
    dyn = cfg.dynamics
    bx, by = bc_pair(cfg)
    rho_b, _, _ = base_profiles(grid)
    rdx, rdy = grid.rdx, grid.rdy
    rdz = 1.0 / grid.dz
    rho_c = rho_b.reshape(-1, 1, 1)
    ho, vo = dyn.h_adv_order, dyn.v_adv_order

    rho_u = rho_c * s.u
    rho_v = rho_c * s.v
    rho_w = _rho_faces(rho_b).reshape(-1, 1, 1) * s.w

    def staggered(axis, bc):
        # mass fluxes averaged onto the u (or v) points along ``axis``
        return [0.5 * (m + shift(m, -1, axis, bc)) for m in (rho_u, rho_v, rho_w)]

    t_u = _advective_tendency(s.u, *staggered(AXIS_X, bx), rho_c, rdx, rdy, rdz,
                              ho, vo, bx, by)
    t_v = _advective_tendency(s.v, *staggered(AXIS_Y, by), rho_c, rdx, rdy, rdz,
                              ho, vo, bx, by)

    # w: 2nd-order advective form on w levels
    u_w = _w_levels(0.5 * (s.u + shift(s.u, 1, AXIS_X, bx)))
    v_w = _w_levels(0.5 * (s.v + shift(s.v, 1, AXIS_Y, by)))
    dwdx = (shift(s.w, 1, AXIS_X, bx) - shift(s.w, -1, AXIS_X, bx)) * 0.5 * rdx
    dwdy = (shift(s.w, 1, AXIS_Y, by) - shift(s.w, -1, AXIS_Y, by)) * 0.5 * rdy
    dz_f = _w_levels(grid.dz).reshape(-1, 1, 1)
    zero = torch.zeros_like(s.w[:1])
    dwdz = torch.cat([zero, 0.5 * (s.w[2:] - s.w[:-2]) / dz_f[1:-1], zero], dim=0)
    t_w = -(u_w * dwdx + v_w * dwdy + s.w * dwdz)

    t_th = _advective_tendency(s.theta_p, rho_u, rho_v, rho_w, rho_c,
                               rdx, rdy, rdz, ho, vo, bx, by)

    kh = None
    if dyn.diff_opt == 1 and dyn.khdif > 0:
        kh = dyn.khdif
    elif dyn.diff_opt == 2:
        kh = (tke_eddy_coeffs(s, grid, cfg)[1] if dyn.km_opt == 2
              else smagorinsky_khh(s, grid, cfg))
    if kh is not None:
        t_u = t_u + kh * laplacian_h(s.u, rdx, rdy, bx, by)
        t_v = t_v + kh * laplacian_h(s.v, rdx, rdy, bx, by)
        t_th = t_th + kh * laplacian_h(s.theta_p, rdx, rdy, bx, by)
    return _SlowTend(u=t_u, v=t_v, w=t_w, theta=t_th)


def _acoustic_integrate(state_t: DycoreState, tend: _SlowTend, theta_stage,
                        grid: Grid, cfg: Config, dts, ns: int):
    """``ns`` acoustic substeps over one RK stage interval ``dts``:
    forward-backward horizontal momentum, then the vertically implicit w-p
    column solve with off-centering beta = (1 + epssm)/2, one K1 launch a
    substep on the card.  Buoyancy g theta'/theta_b is frozen at the
    stage's ``theta_stage``.  Returns (u, v, w, p')."""
    dyn = cfg.dynamics
    bx, by = bc_pair(cfg)
    rho_b, theta_b, cs2 = base_profiles(grid)
    alpha_b = grid.alpha_base
    rdx, rdy = grid.rdx, grid.rdy
    dz_c = grid.dz.reshape(-1, 1, 1)
    dtau = dts / ns
    beta = 0.5 * (1.0 + dyn.epssm)

    rhocs2 = (rho_b * cs2).reshape(-1, 1, 1)
    alpha_c = alpha_b.reshape(-1, 1, 1)

    # interior w faces k = 1..nz-1
    dzf = (grid.z_half[1:] - grid.z_half[:-1]).reshape(-1, 1, 1)
    alpha_f = (0.5 * (alpha_b[1:] + alpha_b[:-1])).reshape(-1, 1, 1)
    th_b_f = (0.5 * (theta_b[1:] + theta_b[:-1])).reshape(-1, 1, 1)
    buoy = c.GRAV * (0.5 * (theta_stage[1:] + theta_stage[:-1])) / th_b_f

    # tridiagonal coefficients [nz-1, 1, 1], constant over the stage
    A = (dtau ** 2) * (beta ** 2) * alpha_f / dzf
    rc_up = (rho_b * cs2 / grid.dz).reshape(-1, 1, 1)
    b_diag = 1.0 + A * (rc_up[1:] + rc_up[:-1])
    c_diag = -A * rc_up[1:]
    a_diag = -A * rc_up[:-1]

    u, v, w, pp = state_t.u, state_t.v, state_t.w, state_t.p_p
    pp_prev = pp
    for _ in range(ns):
        pe = pp + dyn.smdiv * (pp - pp_prev)       # divergence-damped p'
        dpdx = (pe - shift(pe, -1, AXIS_X, bx)) * rdx
        dpdy = (pe - shift(pe, -1, AXIS_Y, by)) * rdy
        u = u + dtau * (-alpha_c * dpdx + tend.u)
        v = v + dtau * (-alpha_c * dpdy + tend.v)

        div_h = ((shift(u, 1, AXIS_X, bx) - u) * rdx
                 + (shift(v, 1, AXIS_Y, by) - v) * rdy)
        dzw = (w[1:] - w[:-1]) / dz_c
        p_tilde = pp - dtau * rhocs2 * (div_h + (1.0 - beta) * dzw)
        p_bar = beta * p_tilde + (1.0 - beta) * pp
        dpdz_f = (p_bar[1:] - p_bar[:-1]) / dzf
        rhs = w[1:-1] + dtau * (buoy + tend.w[1:-1]) - dtau * alpha_f * dpdz_f
        zero = torch.zeros_like(w[:1])
        w = torch.cat([zero, tridiag_solve(a_diag, b_diag, c_diag, rhs), zero], dim=0)
        pp_prev, pp = pp, p_tilde - dtau * beta * rhocs2 * ((w[1:] - w[:-1]) / dz_c)
    return u, v, w, pp


def dyn_step(state: DycoreState, grid: Grid, cfg: Config) -> DycoreState:
    """RK3 update of u, v, w, theta' and p' (stages of 1, ns//2 and ns
    acoustic substeps), then the upper-level implicit Rayleigh damping of
    w when ``damp_opt`` is set: tau ramps as sin^2 over the top ``zdamp``
    meters, w <- w / (1 + dt tau)."""
    dyn = cfg.dynamics
    dt = dyn.dt

    def stage(arg: DycoreState, frac: float, ns: int) -> DycoreState:
        tend = _slow_tendencies(arg, grid, cfg)
        u, v, w, pp = _acoustic_integrate(state, tend, arg.theta_p, grid, cfg,
                                          dt * frac, ns)
        return replace(state, u=u, v=v, w=w, p_p=pp,
                       theta_p=state.theta_p + dt * frac * tend.theta)

    ns = max(1, dyn.n_sound)
    s3 = stage(stage(stage(state, 1.0 / 3.0, 1), 0.5, max(1, ns // 2)), 1.0, ns)
    if dyn.damp_opt:
        ztop = grid.z_full[-1]
        zd = grid.z_full.reshape(-1, 1, 1)
        frac = torch.clamp((zd - (ztop - dyn.zdamp)) / max(dyn.zdamp, 1.0), 0.0, 1.0)
        tau = dyn.dampcoef * torch.sin(0.5 * torch.pi * frac) ** 2
        s3 = replace(s3, w=s3.w / (1.0 + dt * tau))
    return s3


# calls of solve_step: captured into a graph (and replayed once), replayed,
# run eagerly
GRAPH_COUNTS = {"captures": 0, "replays": 0, "eager": 0}

# the graphs kept, least recently used first: key -> _Graph, or the grid's
# tensors alone after a key's first (eager) call
_GRAPHS: OrderedDict = OrderedDict()
MAX_GRAPHS = 4


def reset_graph_counts() -> None:
    GRAPH_COUNTS.update(captures=0, replays=0, eager=0)


def read_graph_counts() -> dict:
    """A copy of :data:`GRAPH_COUNTS`."""
    return dict(GRAPH_COUNTS)


def clear_graphs() -> None:
    """Drop every kept graph and its memory."""
    _GRAPHS.clear()


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    static_in: DycoreState
    static_out: tuple            # (DycoreState, StepDiag): the graph's buffers
    grid_tensors: tuple          # the grid's buffers that the graph reads


def _grid_tensors(grid: Grid) -> tuple:
    return tuple(v for v in (getattr(grid, f.name) for f in dataclasses.fields(grid))
                 if isinstance(v, torch.Tensor))


def graph_key(state: DycoreState, grid: Grid, cfg: Config):
    """The key of the graph that runs ``solve_step`` on these arguments, or
    None where the call runs eagerly: a state not wholly on one CUDA
    device, a block grid (its halo exchanges), a leaf that requires grad,
    or a stream that is capturing already.  The key holds each state
    leaf's shape, dtype and strides (None for an absent ``mu``/``ph``),
    the ``Config``, the device, the grid's non-tensor fields and the
    addresses of its buffers, which the graph reads in place."""
    if grid.mesh is not None:
        return None
    leaves, device = [], None
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if t is None:
            leaves.append(None)
            continue
        if t.device.type != "cuda" or t.requires_grad or device not in (None, t.device):
            return None
        device = t.device
        leaves.append((tuple(t.shape), t.dtype, t.stride()))
    if device is None or torch.cuda.is_current_stream_capturing():
        return None
    grid_part = tuple(v.data_ptr() if isinstance(v, torch.Tensor) else v
                      for v in (getattr(grid, f.name) for f in dataclasses.fields(grid)))
    return tuple(leaves), cfg, device, grid_part


def _capture(state: DycoreState, grid: Grid, cfg: Config) -> _Graph:
    """The step captured on a copy of ``state``, on a side stream (the
    legacy default stream cannot capture), into the graph's own memory
    pool; the capture runs nothing, the caller replays it.  Not through
    ``torch.cuda.graph``, which empties the allocator's cache first: the
    particle step after it would then allocate all its buffers anew."""
    static_in = tree_map(torch.clone, state)
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(state.u.device)
    side = torch.cuda.Stream(state.u.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            static_out = _solve_step_eager(static_in, grid, cfg)
        finally:
            graph.capture_end()
    main.wait_stream(side)
    return _Graph(graph, static_in, static_out, _grid_tensors(grid))


def solve_step(state: DycoreState, grid: Grid, cfg: Config):
    """One full dycore timestep: dynamics, then the scalar families
    advected with per-class flux capture and the microphysics adjustment
    (Kessler, WSM5 or Morrison for mp_physics 1/2/10).  Returns
    (new_state, StepDiag).  The ARW core runs when ``dyn_opt == "arw"`` and
    the state carries ``mu``; otherwise the linear core.  On a block
    ``grid`` (``grid.block_grid``) the state is the rank's block and every
    horizontal neighbour access is a block stencil (``ops.stencil``).

    Where :func:`graph_key` gives a key, the second call with it captures
    the step in a CUDA graph and later calls replay it: the state's leaves
    are copied into the graph's inputs, and the returned state is a fresh
    copy of its outputs, so it stays valid.  The returned ``StepDiag`` is
    then the graph's own buffers: valid until the next call with the same
    key."""
    key = graph_key(state, grid, cfg)
    if key is None:
        GRAPH_COUNTS["eager"] += 1
        return _solve_step_eager(state, grid, cfg)
    entry = _GRAPHS.get(key)
    if entry is None:
        _GRAPHS[key] = _grid_tensors(grid)
        if len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
        GRAPH_COUNTS["eager"] += 1
        return _solve_step_eager(state, grid, cfg)
    _GRAPHS.move_to_end(key)
    if isinstance(entry, _Graph):
        _copy_into(entry.static_in, state)
        GRAPH_COUNTS["replays"] += 1
    else:
        entry = _GRAPHS[key] = _capture(state, grid, cfg)
        GRAPH_COUNTS["captures"] += 1
    entry.graph.replay()
    new, diag = entry.static_out
    return tree_map(torch.clone, new), diag


def _copy_into(dst: DycoreState, src: DycoreState) -> None:
    """Copy every tensor leaf of ``src`` into ``dst``'s in place."""
    for f in dataclasses.fields(dst):
        d = getattr(dst, f.name)
        if d is not None:
            d.copy_(getattr(src, f.name))


def _solve_step_eager(state: DycoreState, grid: Grid, cfg: Config):
    """:func:`solve_step`'s work, run as it is called."""
    with on_grid(grid):
        if cfg.dynamics.dyn_opt == "arw" and state.mu is not None:
            from .arw import solve_step_arw

            return solve_step_arw(state, grid, cfg)
        return _solve_step_linear(state, grid, cfg)


def _solve_step_linear(state: DycoreState, grid: Grid, cfg: Config):
    dyn = cfg.dynamics
    bx, by = bc_pair(cfg)
    rho_b, _, _ = base_profiles(grid)
    rdz = 1.0 / grid.dz
    new = state if dyn.constant_velocity else dyn_step(state, grid, cfg)

    # time-averaged mass-flux winds for the scalar transport
    rho_c = rho_b.reshape(-1, 1, 1)
    rho_u = rho_c * 0.5 * (state.u + new.u)
    rho_v = rho_c * 0.5 * (state.v + new.v)
    rho_w = _rho_faces(rho_b).reshape(-1, 1, 1) * 0.5 * (state.w + new.w)

    def adv(q, opt):
        fn = rk3_advect_mono if opt == "mono" else rk3_advect_pd
        return fn(q, rho_u, rho_v, rho_w, rho_b, dyn.dt, grid.rdx, grid.rdy,
                  rdz, dyn.h_adv_order, dyn.v_adv_order, bx, by,
                  w_prob_cap=cfg.partmc.w_prob_cap)

    moist, _ = adv(state.moist, dyn.moist_adv_opt)
    chem, _ = adv(state.chem, dyn.chem_adv_opt)
    num_conc, probs = adv(state.num_conc, dyn.chem_adv_opt)

    if dyn.diff_opt == 2 and dyn.km_opt == 2:
        tke_new, xkhh = tke_advance(new, grid, cfg, dyn.dt)
        new = replace(new, tke=tke_new)
    elif dyn.diff_opt == 2:
        xkhh = smagorinsky_khh(new, grid, cfg)
    else:
        xkhh = torch.full((grid.nz, grid.ny, grid.nx), dyn.khdif,
                          dtype=torch.float32, device=state.u.device)
    new = replace(new, moist=moist, chem=chem, num_conc=num_conc)
    if dyn.mp_physics == 1:
        new = kessler_step(new, grid, dyn.dt)
    elif dyn.mp_physics == 2:
        new = wsm5_step(new, grid, dyn.dt)
    elif dyn.mp_physics == 10:
        new = morrison_step(new, grid, dyn.dt)
    return new, StepDiag(probs=probs, xkhh=xkhh, rho_u=rho_u, rho_v=rho_v,
                         rho_w=rho_w)
