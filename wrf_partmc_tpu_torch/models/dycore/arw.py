"""Full mass-coordinate nonhydrostatic dynamical core (dyn_opt="arw").

Port of ``wrf_partmc_tpu/models/dycore/arw.py``: prognostic dry column mass
mu_d and geopotential phi, RK3 split-explicit integration with acoustic
substeps about each RK stage state, and the vertically implicit W'' column
solve through ``ops.tridiag.solve`` (kernel K1 on CUDA).  The acoustic
``lax.scan`` of the reference is a Python loop here.  Expressions keep the
reference's operation order so that float32 results agree to rounding.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import constants as c
from ...config import Config
from ...grid import Grid
from ...ops.advection import face_fluxes, flux_divergence
from ...ops.stencil import AXIS_X, AXIS_Y, shift
from ...ops.tridiag import solve as tridiag_solve
from ..physics.microphysics import kessler_step, wsm5_step
from ..physics.morrison import morrison_step
from ..physics.sfs_nba import nba_stress_tendencies
from .solve import bc_pair, horizontal_k, laplacian_h
from .state import DycoreState, replace


def _map_factors(grid: Grid, cfg: Config):
    """(m, m_u, m_v, m^2) [ny, nx] with m = grid.msft."""
    bx, by = bc_pair(cfg)
    m = grid.msft
    return m, _avg_xf(m, bx), _avg_yf(m, by), m * m


def _avg_xf(f, bx):
    """Cell value -> west (u) face: 0.5 (f[i-1] + f[i])."""
    return 0.5 * (f + shift(f, -1, AXIS_X, bx))


def _avg_yf(f, by):
    return 0.5 * (f + shift(f, -1, AXIS_Y, by))


def _avg_zf(f):
    """Cell levels [nz,...] -> w faces [nz+1,...] (ends clamped)."""
    mid = 0.5 * (f[1:] + f[:-1])
    return torch.cat([f[:1], mid, f[-1:]], dim=0)


def _avg_fz(f):
    """w faces [nz+1,...] -> cell levels [nz,...]."""
    return 0.5 * (f[1:] + f[:-1])


def _deta_face(grid: Grid):
    """eta spacing between half levels, at interior faces 1..nz-1 [nz-1]."""
    return grid.eta_half[:-1] - grid.eta_half[1:]


def _d_eta_half(f, grid: Grid):
    """d f / d eta at half levels (centered interior, one-sided ends)."""
    eh = grid.eta_half
    d_int = (f[:-2] - f[2:]) / (eh[:-2] - eh[2:]).reshape(-1, *([1] * (f.dim() - 1)))
    d_lo = (f[:1] - f[1:2]) / (eh[0] - eh[1])
    d_hi = (f[-2:-1] - f[-1:]) / (eh[-2] - eh[-1])
    return torch.cat([d_lo, d_int, d_hi], dim=0)


def _eos(s: DycoreState, grid: Grid):
    """Pressure split p = pb_eff + p' through ratio factors that are exactly 1
    at the base state.  Returns (p_pert, pb_eff, alb_eff)."""
    deta3 = grid.deta.reshape(-1, 1, 1)
    phbd = grid.phb[1:] - grid.phb[:-1]
    phd = s.ph[1:] - s.ph[:-1]
    alb_eff = phbd / (grid.mub[None] * deta3)
    pb_eff = c.P0 * (c.R_D * c.T0 / (c.P0 * alb_eff)) ** c.GAMMA
    qv = s.moist[0]
    r = ((1.0 + s.theta_p / c.T0) * (1.0 + (c.R_V / c.R_D) * qv)
         * (1.0 + s.mu / grid.mub)[None] / (1.0 + phd / phbd))
    p_pert = pb_eff * torch.expm1(c.GAMMA * torch.log(r))
    return p_pert, pb_eff, alb_eff


def diagnose(s: DycoreState, grid: Grid, n_moist_mass: int = 0):
    """mu_d, phi, alpha_d, full p, dry theta, theta_m, q_tot."""
    mu_d = grid.mub + s.mu
    phi = grid.phb + s.ph
    theta = c.T0 + s.theta_p
    deta = grid.deta.reshape(-1, 1, 1)
    alpha_d = (phi[1:] - phi[:-1]) / (mu_d[None] * deta)
    qv = s.moist[0]
    nm = n_moist_mass if n_moist_mass > 0 else s.moist.shape[0]
    q_tot = torch.sum(s.moist[:nm], dim=0)
    theta_m = theta * (1.0 + (c.R_V / c.R_D) * qv)
    p_pert, pb_eff, _ = _eos(s, grid)
    p = pb_eff + p_pert
    return mu_d, phi, alpha_d, p, theta, theta_m, q_tot


def _rev_cumsum0(a):
    """sum_{j>=k} a[j] along dim 0."""
    return torch.flip(torch.cumsum(torch.flip(a, [0]), dim=0), [0])


def _omega_from_fluxes(U, V, grid: Grid, cfg: Config, msq=1.0):
    """Eta mass flux Omega at w faces [nz+1, ny, nx] and mu_t [ny, nx]."""
    bx, by = bc_pair(cfg)
    D = msq * ((shift(U, 1, AXIS_X, bx) - U) * grid.rdx
               + (shift(V, 1, AXIS_Y, by) - V) * grid.rdy)
    deta = grid.deta.reshape(-1, 1, 1)
    mu_t = -torch.sum(D * deta, dim=0)
    incr = (mu_t[None] + D) * deta
    csum = _rev_cumsum0(incr)
    omega = torch.cat([-csum, torch.zeros_like(csum[:1])], dim=0)
    return omega, mu_t


def _surface_w(u, v, grid: Grid, cfg: Config):
    """Terrain kinematic BC: w at the surface face = u dh/dX + v dh/dY."""
    bx, by = bc_pair(cfg)
    m, _, _, _ = _map_factors(grid, cfg)
    hx = m * (shift(grid.hgt, 1, AXIS_X, bx)
              - shift(grid.hgt, -1, AXIS_X, bx)) * 0.5 * grid.rdx
    hy = m * (shift(grid.hgt, 1, AXIS_Y, by)
              - shift(grid.hgt, -1, AXIS_Y, by)) * 0.5 * grid.rdy
    u_c = 0.5 * (u[0] + shift(u[0], 1, AXIS_X, bx))
    v_c = 0.5 * (v[0] + shift(v[0], 1, AXIS_Y, by))
    return u_c * hx + v_c * hy


def _zero_faces(a, nz: int):
    """a with the surface face and the top face set to zero."""
    out = a.clone()
    out[0] = 0.0
    out[nz] = 0.0
    return out


@dataclass(frozen=True)
class _ArwTend:
    """Large-step tendencies at the RK stage state."""

    U: torch.Tensor          # [nz, ny, nx]
    V: torch.Tensor
    W: torch.Tensor          # [nz+1, ny, nx]
    T: torch.Tensor          # [nz, ny, nx] coupled theta
    PH: torch.Tensor         # [nz+1, ny, nx]
    mu_t: torch.Tensor       # [ny, nx]


def _slow_tendencies(s: DycoreState, grid: Grid, cfg: Config) -> _ArwTend:
    dyn = cfg.dynamics
    bx, by = bc_pair(cfg)
    rdx, rdy = grid.rdx, grid.rdy
    rdeta = 1.0 / grid.deta
    ho, vo = dyn.h_adv_order, dyn.v_adv_order

    mu_d, phi, alpha_d, p, theta, theta_m, q_tot = diagnose(
        s, grid, cfg.n_moist_mass)
    m, m_u, m_v, msq = _map_factors(grid, cfg)
    ratio = 1.0 / (1.0 + q_tot)
    alpha = alpha_d * ratio
    mu_u = _avg_xf(mu_d, bx)[None]
    mu_v = _avg_yf(mu_d, by)[None]
    U = mu_u * s.u / m_u
    V = mu_v * s.v / m_v
    omega, mu_t = _omega_from_fluxes(U, V, grid, cfg, msq)
    fzm = -omega

    mfx_u = _avg_xf(U, bx)
    mfy_u = _avg_xf(V, bx)
    mfz_u = _avg_xf(fzm, bx) / m_u
    fx, fy, fz = face_fluxes(s.u, mfx_u, mfy_u, mfz_u, ho, vo, bx, by)
    adv_U = -flux_divergence(fx, fy, fz, rdx * m_u, rdy * m_u, rdeta)
    mfx_v = _avg_yf(U, by)
    mfy_v = _avg_yf(V, by)
    mfz_v = _avg_yf(fzm, by) / m_v
    fx, fy, fz = face_fluxes(s.v, mfx_v, mfy_v, mfz_v, ho, vo, bx, by)
    adv_V = -flux_divergence(fx, fy, fz, rdx * m_v, rdy * m_v, rdeta)

    fx, fy, fz = face_fluxes(theta, U, V, fzm, ho, vo, bx, by)
    adv_T = -flux_divergence(fx, fy, fz, rdx * msq, rdy * msq, rdeta)

    p_pert, pb_eff, alb_eff = _eos(s, grid)
    dppdx = (p_pert - shift(p_pert, -1, AXIS_X, bx)) * rdx
    dppdy = (p_pert - shift(p_pert, -1, AXIS_Y, by)) * rdy
    dpbdx = (pb_eff - shift(pb_eff, -1, AXIS_X, bx)) * rdx
    dpbdy = (pb_eff - shift(pb_eff, -1, AXIS_Y, by)) * rdy
    dpdeta_h = _d_eta_half(p, grid)
    dpb_deta_h = _d_eta_half(pb_eff, grid)
    php_h = _avg_fz(s.ph)
    phb_h = _avg_fz(grid.phb)
    dphpdx = (php_h - shift(php_h, -1, AXIS_X, bx)) * rdx
    dphpdy = (php_h - shift(php_h, -1, AXIS_Y, by)) * rdy
    dphbdx = (phb_h - shift(phb_h, -1, AXIS_X, bx)) * rdx
    dphbdy = (phb_h - shift(phb_h, -1, AXIS_Y, by)) * rdy
    mual = mu_d[None] * alpha - grid.mub[None] * alb_eff
    rdp = ratio * dpdeta_h
    pgf_U = (mu_u * _avg_xf(alpha, bx) * dppdx
             + _avg_xf(mual, bx) * dpbdx
             + _avg_xf(rdp, bx) * dphpdx
             + _avg_xf(rdp - dpb_deta_h, bx) * dphbdx)
    pgf_V = (mu_v * _avg_yf(alpha, by) * dppdy
             + _avg_yf(mual, by) * dpbdy
             + _avg_yf(rdp, by) * dphpdy
             + _avg_yf(rdp - dpb_deta_h, by) * dphbdy)

    f_u = _avg_xf(grid.f_cor, bx)[None]
    f_v = _avg_yf(grid.f_cor, by)[None]
    v_at_u = _avg_xf(0.5 * (V + shift(V, 1, AXIS_Y, by)), bx)
    u_at_v = _avg_yf(0.5 * (U + shift(U, 1, AXIS_X, bx)), by)
    cor_U = f_u * v_at_u
    cor_V = -f_v * u_at_v

    u_c = 0.5 * (s.u + shift(s.u, 1, AXIS_X, bx))
    v_c = 0.5 * (s.v + shift(s.v, 1, AXIS_Y, by))
    u_f = _avg_zf(u_c)
    v_f = _avg_zf(v_c)
    dwdx = (shift(s.w, 1, AXIS_X, bx) - shift(s.w, -1, AXIS_X, bx)) * 0.5 * rdx
    dwdy = (shift(s.w, 1, AXIS_Y, by) - shift(s.w, -1, AXIS_Y, by)) * 0.5 * rdy
    ef = grid.eta_full
    dwdeta_int = (s.w[:-2] - s.w[2:]) / (ef[:-2] - ef[2:]).reshape(-1, 1, 1)
    dwdeta = torch.cat([torch.zeros_like(s.w[:1]), dwdeta_int,
                        torch.zeros_like(s.w[:1])], dim=0)
    om_small = omega / mu_d[None]
    adv_w = -(m * (u_f * dwdx + v_f * dwdy) + om_small * dwdeta)
    def_f = _deta_face(grid).reshape(-1, 1, 1)
    dpp_f = torch.cat(
        [torch.zeros_like(p_pert[:1]), (p_pert[:-1] - p_pert[1:]) / def_f,
         torch.zeros_like(p_pert[:1])], dim=0)
    ratio_f = _avg_zf(ratio)
    buoy = c.GRAV * (ratio_f * dpp_f + (ratio_f - 1.0) * grid.mub[None]
                     - s.mu[None])
    R_W = _zero_faces(mu_d[None] * adv_w + buoy, grid.nz)

    phx = (shift(phi, 1, AXIS_X, bx) - shift(phi, -1, AXIS_X, bx)) * 0.5 * rdx
    phy = (shift(phi, 1, AXIS_Y, by) - shift(phi, -1, AXIS_Y, by)) * 0.5 * rdy
    dphideta_int = (phi[:-2] - phi[2:]) / (ef[:-2] - ef[2:]).reshape(-1, 1, 1)
    dphideta = torch.cat([torch.zeros_like(phi[:1]), dphideta_int,
                          torch.zeros_like(phi[:1])], dim=0)
    U_f = _avg_zf(0.5 * (U + shift(U, 1, AXIS_X, bx)))
    V_f = _avg_zf(0.5 * (V + shift(V, 1, AXIS_Y, by)))
    R_PH = (c.GRAV * s.w
            - (msq * (U_f * phx + V_f * phy) + omega * dphideta)
            / mu_d[None])
    R_PH[0] = 0.0                                # surface phi fixed

    if dyn.diff_opt in (1, 2):
        kh = horizontal_k(s, grid, cfg)
        msq_u = m_u * m_u
        msq_v = m_v * m_v
        adv_U = adv_U + mu_u * kh * msq_u * laplacian_h(s.u, rdx, rdy, bx, by)
        adv_V = adv_V + mu_v * kh * msq_v * laplacian_h(s.v, rdx, rdy, bx, by)
        adv_T = adv_T + mu_d[None] * kh * msq * laplacian_h(theta, rdx, rdy,
                                                            bx, by)

    # NBA1 nonlinear subfilter stress (sfs_opt=1) on top of the linear
    # closure
    if dyn.sfs_opt == 1:
        du, dv, dw = nba_stress_tendencies(u_c, v_c, _avg_fz(s.w), grid, bx, by)
        adv_U = adv_U + mu_u * _avg_xf(du, bx)
        adv_V = adv_V + mu_v * _avg_yf(dv, by)
        R_W = R_W + _zero_faces(mu_d[None] * _avg_zf(dw), grid.nz)

    return _ArwTend(U=adv_U - pgf_U + cor_U, V=adv_V - pgf_V + cor_V,
                    W=R_W, T=adv_T, PH=R_PH, mu_t=mu_t)


def _acoustic_arw(state_t: DycoreState, s_arg: DycoreState, tend: _ArwTend,
                  grid: Grid, cfg: Config, dts, ns: int, collect_avg: bool):
    """Acoustic substep loop about the RK stage state s_arg from time-t
    values.  Returns the stage-end state and, when ``collect_avg``, the
    substep-averaged mass fluxes (U, V, fzm=-Omega)."""
    dyn = cfg.dynamics
    bx, by = bc_pair(cfg)
    rdx, rdy = grid.rdx, grid.rdy
    nz = grid.nz
    deta = grid.deta.reshape(-1, 1, 1)
    def_f = _deta_face(grid).reshape(-1, 1, 1)
    dtau = dts / ns
    beta = 0.5 * (1.0 + dyn.epssm)

    mu_s, phi_s, alpha_s, p_s, theta_s, theta_m_s, q_tot_s = diagnose(
        s_arg, grid, cfg.n_moist_mass)
    m, m_u, m_v, msq = _map_factors(grid, cfg)
    ratio_s = 1.0 / (1.0 + q_tot_s)
    mu_su = _avg_xf(mu_s, bx)[None]
    mu_sv = _avg_yf(mu_s, by)[None]
    U_s = mu_su * s_arg.u / m_u
    V_s = mu_sv * s_arg.v / m_v
    W_s = mu_s[None] * s_arg.w
    T_s = mu_s[None] * theta_s
    omega_s, _ = _omega_from_fluxes(U_s, V_s, grid, cfg, msq)

    dpdx_s = (p_s - shift(p_s, -1, AXIS_X, bx)) * rdx
    dpdy_s = (p_s - shift(p_s, -1, AXIS_Y, by)) * rdy
    dpdeta_h_s = _d_eta_half(p_s, grid)
    phi_h_s = _avg_fz(phi_s)
    dphidx_s = (phi_h_s - shift(phi_h_s, -1, AXIS_X, bx)) * rdx
    dphidy_s = (phi_h_s - shift(phi_h_s, -1, AXIS_Y, by)) * rdy

    gp = c.GAMMA * p_s
    c3 = gp / (deta * alpha_s * mu_s[None])
    alpha_f_s = _avg_zf(alpha_s)
    ratio_f_s = _avg_zf(ratio_s)

    # implicit tridiagonal coefficients at interior faces k=1..nz-1
    ratio_int = ratio_f_s[1:-1]
    E = (dtau ** 2) * (c.GRAV ** 2) * (beta ** 2) * ratio_int \
        / (def_f * mu_s[None])
    c3_lo = c3[:-1]
    c3_hi = c3[1:]
    A_d = -E * c3_lo
    C_d = -E * c3_hi
    B_d = 1.0 + E * (c3_lo + c3_hi)
    A_d[0] = 0.0                                 # phi'' fixed at the surface
    C_d[-1] = 0.0                                # rigid lid: W_top = 0
    a_w = dtau * c.GRAV * beta / mu_s[None]

    mu_t0 = grid.mub + state_t.mu
    th_t = c.T0 + state_t.theta_p
    Upp = _avg_xf(mu_t0, bx)[None] * state_t.u / m_u - U_s
    Vpp = _avg_yf(mu_t0, by)[None] * state_t.v / m_v - V_s
    Wpp = mu_t0[None] * state_t.w - W_s
    Tpp = mu_t0[None] * th_t - T_s
    PHpp = state_t.ph - s_arg.ph
    MUpp = state_t.mu - s_arg.mu

    def p_pert(Tpp, MUpp, PHpp):
        th_unc = (Tpp - theta_s * MUpp[None]) / mu_s[None]
        dphi = PHpp[1:] - PHpp[:-1]
        return gp * (th_unc / theta_s + MUpp[None] / mu_s[None]) - c3 * dphi

    acc = (torch.zeros_like(Upp), torch.zeros_like(Vpp), torch.zeros_like(Wpp))
    pp_prev = p_pert(Tpp, MUpp, PHpp)
    for _ in range(ns):
        pp = p_pert(Tpp, MUpp, PHpp)
        pe = pp + dyn.smdiv * (pp - pp_prev)

        # advance_uv: perturbation PGF with stage-gradient cross terms
        alpha_pp = ((PHpp[1:] - PHpp[:-1]) / deta
                    - alpha_s * MUpp[None]) / mu_s[None]
        dpdx_pp = (pe - shift(pe, -1, AXIS_X, bx)) * rdx
        dpdy_pp = (pe - shift(pe, -1, AXIS_Y, by)) * rdy
        dpe_deta = _d_eta_half(pe, grid)
        ph_h_pp = _avg_fz(PHpp)
        dphx_pp = (ph_h_pp - shift(ph_h_pp, -1, AXIS_X, bx)) * rdx
        dphy_pp = (ph_h_pp - shift(ph_h_pp, -1, AXIS_Y, by)) * rdy
        pgfx = (mu_su * _avg_xf(alpha_s, bx) * dpdx_pp
                + _avg_xf(MUpp[None] * alpha_s + mu_s[None] * alpha_pp, bx)
                * dpdx_s
                + _avg_xf(ratio_s * dpe_deta, bx) * dphidx_s
                + _avg_xf(ratio_s * dpdeta_h_s, bx) * dphx_pp)
        pgfy = (mu_sv * _avg_yf(alpha_s, by) * dpdy_pp
                + _avg_yf(MUpp[None] * alpha_s + mu_s[None] * alpha_pp, by)
                * dpdy_s
                + _avg_yf(ratio_s * dpe_deta, by) * dphidy_s
                + _avg_yf(ratio_s * dpdeta_h_s, by) * dphy_pp)
        Upp = Upp + dtau * (-pgfx + tend.U)
        Vpp = Vpp + dtau * (-pgfy + tend.V)

        # advance_mu_t: perturbation continuity + acoustic theta flux
        Dpp = msq * ((shift(Upp, 1, AXIS_X, bx) - Upp) * rdx
                     + (shift(Vpp, 1, AXIS_Y, by) - Vpp) * rdy)
        mu_t_pp = -torch.sum(Dpp * deta, dim=0)
        MUpp_new = MUpp + dtau * (tend.mu_t + mu_t_pp)
        incr = (mu_t_pp[None] + Dpp) * deta
        csum = _rev_cumsum0(incr)
        OMpp = torch.cat([-csum, torch.zeros_like(csum[:1])], dim=0)
        fx_t = Upp * _avg_xf(theta_s, bx)
        fy_t = Vpp * _avg_yf(theta_s, by)
        th_f = _avg_zf(theta_s)
        fz_t = _zero_faces(-OMpp * th_f, nz)
        div_t = (msq * ((shift(fx_t, 1, AXIS_X, bx) - fx_t) * rdx
                        + (shift(fy_t, 1, AXIS_Y, by) - fy_t) * rdy)
                 + (fz_t[1:] - fz_t[:-1]) / deta)
        Tpp_new = Tpp + dtau * (tend.T - div_t)

        # advance_w: implicit column solve for W''^{new} (kernel K1)
        th_unc_new = (Tpp_new - theta_s * MUpp_new[None]) / mu_s[None]
        P0 = gp * (th_unc_new / theta_s + MUpp_new[None] / mu_s[None])
        S_ph = tend.PH + OMpp * alpha_f_s
        phat = PHpp + dtau * ((1.0 - beta) * c.GRAV * Wpp / mu_s[None] + S_ph)
        phat[0] = 0.0                            # surface phi fixed
        u_new = (U_s + Upp) * m_u \
            / (_avg_xf(grid.mub + s_arg.mu + MUpp_new, bx)[None])
        v_new = (V_s + Vpp) * m_v \
            / (_avg_yf(grid.mub + s_arg.mu + MUpp_new, by)[None])
        w_sfc = _surface_w(u_new, v_new, grid, cfg)
        W_sfc_pp = (grid.mub + s_arg.mu + MUpp_new) * w_sfc - W_s[0]

        dP0 = P0[:-1] - P0[1:]
        dphat_lo = phat[1:-1] - phat[:-2]
        dphat_hi = phat[2:] - phat[1:-1]
        dp_new_known = dP0 - c3_lo * dphat_lo + c3_hi * dphat_hi
        pp_cur_f = (pp[:-1] - pp[1:])
        rhs = (Wpp[1:-1] + dtau * tend.W[1:-1]
               + dtau * c.GRAV * ratio_int
               * (beta * dp_new_known + (1.0 - beta) * pp_cur_f) / def_f
               - dtau * c.GRAV * MUpp_new[None])
        W_int = tridiag_solve(A_d, B_d, C_d, rhs)
        Wpp_new = torch.cat([W_sfc_pp[None], W_int, torch.zeros_like(Wpp[:1])],
                            dim=0)
        PHpp_new = phat + a_w * Wpp_new
        PHpp_new[0] = 0.0

        if collect_avg:
            om_new = omega_s + OMpp
            acc = (acc[0] + (U_s + Upp), acc[1] + (V_s + Vpp), acc[2] - om_new)
        Wpp, Tpp, PHpp, MUpp, pp_prev = Wpp_new, Tpp_new, PHpp_new, MUpp_new, pp

    mu_new = s_arg.mu + MUpp
    mu_d_new = grid.mub + mu_new
    u_new = (U_s + Upp) * m_u / _avg_xf(mu_d_new, bx)[None]
    v_new = (V_s + Vpp) * m_v / _avg_yf(mu_d_new, by)[None]
    w_new = (W_s + Wpp) / mu_d_new[None]
    th_new = (T_s + Tpp) / mu_d_new[None]
    out = replace(state_t, u=u_new, v=v_new, w=w_new,
                  theta_p=th_new - c.T0, mu=mu_new, ph=s_arg.ph + PHpp)
    fluxes = tuple(a / ns for a in acc) if collect_avg else None
    return out, fluxes


def dyn_step_arw(state: DycoreState, grid: Grid, cfg: Config):
    """RK3 update of the mass-coordinate dynamic variables; returns the new
    state plus the acoustic-averaged mass fluxes of the final stage."""
    dyn = cfg.dynamics
    dt = dyn.dt
    ns = max(1, dyn.n_sound)

    t1 = _slow_tendencies(state, grid, cfg)
    s1, _ = _acoustic_arw(state, state, t1, grid, cfg, dt / 3.0, 1, False)
    t2 = _slow_tendencies(s1, grid, cfg)
    s2, _ = _acoustic_arw(state, s1, t2, grid, cfg, dt / 2.0,
                          max(1, ns // 2), False)
    t3 = _slow_tendencies(s2, grid, cfg)
    s3, fluxes = _acoustic_arw(state, s2, t3, grid, cfg, dt, ns, True)

    if dyn.damp_opt:
        ztop = grid.ztop
        zf = (grid.phb + s3.ph) / c.GRAV
        frac = torch.clamp((zf - (ztop - dyn.zdamp)) / max(dyn.zdamp, 1.0),
                           0.0, 1.0)
        tau = dyn.dampcoef * torch.sin(0.5 * torch.pi * frac) ** 2
        s3 = replace(s3, w=s3.w / (1.0 + dt * tau))
    return s3, fluxes


def solve_step_arw(state: DycoreState, grid: Grid, cfg: Config):
    """One full mass-coordinate dycore timestep: RK3 dynamics + mu-coupled
    scalar families advected with the acoustic-averaged fluxes, with
    per-class flux capture, then the microphysics adjustment (Kessler,
    WSM5 or Morrison for mp_physics 1/2/10).  Returns (new_state, StepDiag)."""
    from ...ops.advection import rk3_advect_mono, rk3_advect_pd
    from .solve import StepDiag, smagorinsky_khh, tke_advance

    dyn = cfg.dynamics
    bx, by = bc_pair(cfg)
    rdeta = 1.0 / grid.deta

    m, m_u, m_v, msq = _map_factors(grid, cfg)
    mu_old = grid.mub + state.mu
    if dyn.constant_velocity:
        new = state
        U = _avg_xf(mu_old, bx)[None] * state.u / m_u
        V = _avg_yf(mu_old, by)[None] * state.v / m_v
        omega, _ = _omega_from_fluxes(U, V, grid, cfg, msq)
        fluxes = (U, V, -omega)
    else:
        new, fluxes = dyn_step_arw(state, grid, cfg)
    mu_new = grid.mub + new.mu
    U_avg, V_avg, fzm_avg = fluxes

    def adv(q, opt):
        fn = rk3_advect_mono if opt == "mono" else rk3_advect_pd
        return fn(q, U_avg, V_avg, fzm_avg, mu_old, dyn.dt, grid.rdx * msq,
                  grid.rdy * msq, rdeta, dyn.h_adv_order, dyn.v_adv_order,
                  bx, by, w_prob_cap=cfg.partmc.w_prob_cap, rho_new=mu_new)

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
    _, _, _, p_full, _, _, _ = diagnose(new, grid, cfg.n_moist_mass)
    new = replace(new, p_p=p_full - grid.p_base.reshape(-1, 1, 1))
    if dyn.mp_physics == 1:
        new = kessler_step(new, grid, dyn.dt)
    elif dyn.mp_physics == 2:
        new = wsm5_step(new, grid, dyn.dt)
    elif dyn.mp_physics == 10:
        new = morrison_step(new, grid, dyn.dt)
    return new, StepDiag(probs=probs, xkhh=xkhh, rho_u=U_avg, rho_v=V_avg,
                         rho_w=fzm_avg)
