"""Finite-volume flux-form advection operators with flux capture.

Port of ``wrf_partmc_tpu/ops/advection.py``: 1st-6th order upwind face
fluxes and the WENO5/WENO3 reconstructions, the positive-definite and
monotonic (FCT) limited RK3 scalar updates, and the per-face outflow
probabilities captured for the particle transport.  Arrays are
[*, nz, ny, nx].
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .stencil import AXIS_X, AXIS_Y, AXIS_Z, make_taps, shift

_HALF = {1: 1, 2: 1, 3: 2, 4: 2, 5: 3, 6: 3}


def _weno_face_value(q, upwind_pos, order: int, axis: int, bc: str,
                     eps: float = 1e-6):
    """WENO reconstruction of q at the face between cells i-1 and i (Jiang &
    Shu 1996), order 5 or 3.  ``upwind_pos``: True where the face velocity
    is >= 0 (donor cell i-1); elsewhere the mirror stencil.  The
    smoothness indicators are computed on the stencil divided by its largest
    magnitude, so that the weights stay finite in float32 for fields of any
    scale; the candidate polynomials use the raw values."""
    half = 3 if order == 5 else 2
    s = make_taps(q, -half, half - 1, axis, bc)

    def weno5(qm3, qm2, qm1, q0, qp1):
        scale = torch.maximum(torch.abs(qm3), torch.maximum(torch.abs(qm2),
                torch.maximum(torch.abs(qm1), torch.maximum(torch.abs(q0),
                torch.abs(qp1))))) + 1e-30
        n3, n2, n1, n0, np1 = (v / scale for v in (qm3, qm2, qm1, q0, qp1))
        b0 = (13.0 / 12.0) * (n3 - 2.0 * n2 + n1) ** 2 \
            + 0.25 * (n3 - 4.0 * n2 + 3.0 * n1) ** 2
        b1 = (13.0 / 12.0) * (n2 - 2.0 * n1 + n0) ** 2 \
            + 0.25 * (n2 - n0) ** 2
        b2 = (13.0 / 12.0) * (n1 - 2.0 * n0 + np1) ** 2 \
            + 0.25 * (3.0 * n1 - 4.0 * n0 + np1) ** 2
        a0 = 0.1 / (eps + b0) ** 2
        a1 = 0.6 / (eps + b1) ** 2
        a2 = 0.3 / (eps + b2) ** 2
        asum = a0 + a1 + a2
        p0 = (2.0 * qm3 - 7.0 * qm2 + 11.0 * qm1) / 6.0
        p1 = (-qm2 + 5.0 * qm1 + 2.0 * q0) / 6.0
        p2 = (2.0 * qm1 + 5.0 * q0 - qp1) / 6.0
        return (a0 / asum) * p0 + (a1 / asum) * p1 + (a2 / asum) * p2

    def weno3(qm2, qm1, q0):
        scale = torch.maximum(torch.abs(qm2),
                              torch.maximum(torch.abs(qm1), torch.abs(q0))) + 1e-30
        n2, n1, n0 = qm2 / scale, qm1 / scale, q0 / scale
        b0 = (n2 - n1) ** 2
        b1 = (n1 - n0) ** 2
        a0 = (1.0 / 3.0) / (eps + b0) ** 2
        a1 = (2.0 / 3.0) / (eps + b1) ** 2
        asum = a0 + a1
        p0 = 1.5 * qm1 - 0.5 * qm2
        p1 = 0.5 * (qm1 + q0)
        return (a0 / asum) * p0 + (a1 / asum) * p1

    if order == 5:
        q_pos = weno5(s(-3), s(-2), s(-1), s(0), s(1))
        q_neg = weno5(s(2), s(1), s(0), s(-1), s(-2))
    elif order == 3:
        q_pos = weno3(s(-2), s(-1), s(0))
        q_neg = weno3(s(1), s(0), s(-1))
    else:
        raise ValueError(f"unsupported WENO order {order}")
    return torch.where(upwind_pos, q_pos, q_neg)


def _upwind_face_flux(q, vel_face, order, axis: int, bc: str):
    """Tracer flux through owner faces: F[i] = vel_face[i] * q at the face
    between cells i-1 and i (even-order flux minus odd-order upwinding, or
    the WENO face value for ``order`` "weno5"/"weno3")."""
    if isinstance(order, str):
        if order not in ("weno5", "weno3"):
            raise ValueError(f"unsupported advection order {order}")
        return vel_face * _weno_face_value(q, vel_face >= 0.0, int(order[-1]), axis, bc)
    if order not in _HALF:
        raise ValueError(f"unsupported advection order {order}")
    s = make_taps(q, -_HALF[order], _HALF[order] - 1, axis, bc)
    u = vel_face
    au = torch.abs(vel_face)
    if order == 1:
        return 0.5 * u * (s(0) + s(-1)) - 0.5 * au * (s(0) - s(-1))
    if order == 2:
        return 0.5 * u * (s(0) + s(-1))
    if order in (3, 4):
        f4 = u * (7.0 * (s(0) + s(-1)) - (s(1) + s(-2))) / 12.0
        if order == 4:
            return f4
        return f4 - au * (3.0 * (s(0) - s(-1)) - (s(1) - s(-2))) / 12.0
    f6 = u * (37.0 * (s(0) + s(-1)) - 8.0 * (s(1) + s(-2)) + (s(2) + s(-3))) / 60.0
    if order == 6:
        return f6
    return f6 - au * (10.0 * (s(0) - s(-1)) - 5.0 * (s(1) - s(-2)) + (s(2) - s(-3))) / 60.0


def _zero_boundary_vertical_flux(flux_w):
    """Zero mass flux through the surface (k=0 face) and model top (k=nz)."""
    out = flux_w.clone()
    out[..., 0, :, :] = 0.0
    out[..., -1, :, :] = 0.0
    return out


def _as_col(rho):
    """[nz] -> [nz,1,1]; [ny,nx] column mass -> [1,ny,nx]; 3-D passes."""
    if rho.dim() == 1:
        return rho.reshape(-1, 1, 1)
    if rho.dim() == 2:
        return rho[None]
    return rho


def face_fluxes(q, rho_u, rho_v, rho_w, h_order: int, v_order: int,
                bc_x: str = "periodic", bc_y: str = "periodic"):
    """High-order tracer fluxes on all faces: (fx, fy, fz) with fz on the
    nz+1 w faces (zero at the surface and the top)."""
    fx = _upwind_face_flux(q, rho_u, h_order, AXIS_X, bc_x)
    fy = _upwind_face_flux(q, rho_v, h_order, AXIS_Y, bc_y)
    # any WENO vertical order runs as weno3; upwind orders above 3 as 3
    vo = "weno3" if isinstance(v_order, str) else min(v_order, 3)
    fz_low = _upwind_face_flux(q, rho_w[..., :-1, :, :], vo, AXIS_Z, "clamp")
    fz = torch.cat([fz_low, torch.zeros_like(fz_low[..., :1, :, :])], dim=-3)
    return fx, fy, _zero_boundary_vertical_flux(fz)


def flux_divergence(fx, fy, fz, rdx, rdy, rdz):
    """div(F) at cell centers.  rdz: [nz] 1/dz."""
    dfx = (shift(fx, 1, AXIS_X) - fx) * rdx
    dfy = (shift(fy, 1, AXIS_Y) - fy) * rdy
    dfz = (fz[..., 1:, :, :] - fz[..., :-1, :, :]) * rdz.reshape(-1, 1, 1)
    return dfx + dfy + dfz


@dataclass(frozen=True)
class OutflowProbs:
    """Per-cell, per-face fractions of tracer mass leaving during dt — the
    move probabilities the stochastic transport consumes.  [*, nz, ny, nx]."""

    xm: torch.Tensor
    xp: torch.Tensor
    ym: torch.Tensor
    yp: torch.Tensor
    zm: torch.Tensor
    zp: torch.Tensor


def _low_order(q, q_stage, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
               h_order, v_order, bc_x, bc_y, rho_new):
    """Shared first half of the limited updates: high/low-order fluxes, the
    monotone transported-diffused field q_td and the antidiffusive fluxes."""
    rho_c = _as_col(rho)
    rho_n = rho_c if rho_new is None else _as_col(rho_new)
    fx_h, fy_h, fz_h = face_fluxes(q_stage, rho_u, rho_v, rho_w, h_order,
                                   v_order, bc_x, bc_y)
    fx_l, fy_l, fz_l = face_fluxes(q, rho_u, rho_v, rho_w, 1, 1, bc_x, bc_y)
    fz_l = _zero_boundary_vertical_flux(fz_l)
    q_td = (rho_c * q - dt * flux_divergence(fx_l, fy_l, fz_l, rdx, rdy, rdz)) / rho_n
    q_td = torch.clamp(q_td, min=0.0)
    return rho_n, q_td, (fx_l, fy_l, fz_l), (fx_h - fx_l, fy_h - fy_l, fz_h - fz_l)


def advect_pd(q, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
              h_order: int = 5, v_order: int = 3,
              bc_x: str = "periodic", bc_y: str = "periodic",
              w_prob_cap: float = 0.95, q_stage=None, rho_new=None):
    """Positive-definite flux-limited advection step with flux capture
    (advect_scalar_pd).  Returns (q_new, OutflowProbs)."""
    if q_stage is None:
        q_stage = q
    rho_n, q_td, (fx_l, fy_l, fz_l), (ax, ay, az) = _low_order(
        q, q_stage, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz, h_order,
        v_order, bc_x, bc_y, rho_new)

    def outgoing(a_face, axis, geom):
        out_lo = torch.clamp(-a_face, min=0.0) * geom
        out_hi = torch.clamp(shift(a_face, 1, axis), min=0.0) * geom
        return out_lo + out_hi

    out_x = outgoing(ax, AXIS_X, rdx)
    out_y = outgoing(ay, AXIS_Y, rdy)
    out_z = (torch.clamp(az[..., 1:, :, :], min=0.0)
             + torch.clamp(-az[..., :-1, :, :], min=0.0)) * rdz.reshape(-1, 1, 1)
    out_total = out_x + out_y + out_z

    avail = rho_n * q_td / dt
    scale = torch.where(out_total > 0.0,
                        torch.clamp(avail / torch.clamp(out_total, min=1e-30),
                                    max=1.0), 1.0)

    def limit(a_face, axis):
        return torch.where(a_face > 0.0, a_face * shift(scale, -1, axis),
                           a_face * scale)

    ax = limit(ax, AXIS_X)
    ay = limit(ay, AXIS_Y)
    sc_pad = torch.cat([scale[..., :1, :, :], scale, scale[..., -1:, :, :]], dim=-3)
    az = torch.where(az > 0.0, az * sc_pad[..., :-1, :, :], az * sc_pad[..., 1:, :, :])
    az = _zero_boundary_vertical_flux(az)

    q_new = q_td - dt * flux_divergence(ax, ay, az, rdx, rdy, rdz) / rho_n
    probs = capture_outflow_probs(q, fx_l + ax, fy_l + ay, fz_l + az, rho, dt,
                                  rdx, rdy, rdz, w_prob_cap)
    return q_new, probs


def advect_mono(q, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
                h_order: int = 5, v_order: int = 3,
                bc_x: str = "periodic", bc_y: str = "periodic",
                w_prob_cap: float = 0.95, q_stage=None, rho_new=None):
    """Monotonic (Zalesak FCT) flux-limited advection step with flux capture
    (advect_scalar_mono).  Returns (q_new, OutflowProbs)."""
    if q_stage is None:
        q_stage = q
    rho_n, q_td, (fx_l, fy_l, fz_l), (ax, ay, az) = _low_order(
        q, q_stage, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz, h_order,
        v_order, bc_x, bc_y, rho_new)
    az = _zero_boundary_vertical_flux(az)

    z_lo = torch.cat([q_td[..., :1, :, :], q_td[..., :-1, :, :]], dim=-3)
    z_hi = torch.cat([q_td[..., 1:, :, :], q_td[..., -1:, :, :]], dim=-3)
    cand = [q, q_td, z_lo, z_hi,
            shift(q_td, 1, AXIS_X, bc_x), shift(q_td, -1, AXIS_X, bc_x),
            shift(q_td, 1, AXIS_Y, bc_y), shift(q_td, -1, AXIS_Y, bc_y)]
    q_max = functools.reduce(torch.maximum, cand)
    q_min = torch.clamp(functools.reduce(torch.minimum, cand), min=0.0)

    def in_out(a_face, axis, geom):
        nxt = shift(a_face, 1, axis)
        inc = (torch.clamp(a_face, min=0.0) + torch.clamp(-nxt, min=0.0)) * geom
        out = (torch.clamp(-a_face, min=0.0) + torch.clamp(nxt, min=0.0)) * geom
        return inc, out

    in_x, out_x = in_out(ax, AXIS_X, rdx)
    in_y, out_y = in_out(ay, AXIS_Y, rdy)
    rdz_c = rdz.reshape(-1, 1, 1)
    in_z = (torch.clamp(az[..., :-1, :, :], min=0.0)
            + torch.clamp(-az[..., 1:, :, :], min=0.0)) * rdz_c
    out_z = (torch.clamp(-az[..., :-1, :, :], min=0.0)
             + torch.clamp(az[..., 1:, :, :], min=0.0)) * rdz_c
    p_in = in_x + in_y + in_z
    p_out = out_x + out_y + out_z

    r_in = torch.where(p_in > 0.0, torch.clamp(
        rho_n * (q_max - q_td) / (dt * torch.clamp(p_in, min=1e-30)), max=1.0), 1.0)
    r_out = torch.where(p_out > 0.0, torch.clamp(
        rho_n * (q_td - q_min) / (dt * torch.clamp(p_out, min=1e-30)), max=1.0), 1.0)
    r_in = torch.clamp(r_in, 0.0, 1.0)
    r_out = torch.clamp(r_out, 0.0, 1.0)

    def limit(a_face, axis):
        fac = torch.where(a_face > 0.0,
                          torch.minimum(r_in, shift(r_out, -1, axis)),
                          torch.minimum(shift(r_in, -1, axis), r_out))
        return a_face * fac

    ax = limit(ax, AXIS_X)
    ay = limit(ay, AXIS_Y)
    pad = lambda a: torch.cat([a[..., :1, :, :], a, a[..., -1:, :, :]], dim=-3)
    rin_p, rout_p = pad(r_in), pad(r_out)
    fac_z = torch.where(az > 0.0,
                        torch.minimum(rin_p[..., 1:, :, :], rout_p[..., :-1, :, :]),
                        torch.minimum(rin_p[..., :-1, :, :], rout_p[..., 1:, :, :]))
    az = _zero_boundary_vertical_flux(az * fac_z)

    q_new = q_td - dt * flux_divergence(ax, ay, az, rdx, rdy, rdz) / rho_n
    probs = capture_outflow_probs(q, fx_l + ax, fy_l + ay, fz_l + az, rho, dt,
                                  rdx, rdy, rdz, w_prob_cap)
    return q_new, probs


def _rk3(limited_step, q, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
         h_order, v_order, bc_x, bc_y, w_prob_cap, rho_new):
    """Wicker-Skamarock RK3: plain high-order stages at dt/3 and dt/2, the
    limited full-dt update on the last stage."""
    rho_c = _as_col(rho)

    def tend(qs):
        fx, fy, fz = face_fluxes(qs, rho_u, rho_v, rho_w, h_order, v_order,
                                 bc_x, bc_y)
        return -flux_divergence(fx, fy, fz, rdx, rdy, rdz) / rho_c

    q1 = q + (dt / 3.0) * tend(q)
    q2 = q + (dt / 2.0) * tend(q1)
    return limited_step(q, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
                        h_order, v_order, bc_x, bc_y, w_prob_cap, q_stage=q2,
                        rho_new=rho_new)


def rk3_advect_pd(q, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
                  h_order: int = 5, v_order: int = 3,
                  bc_x: str = "periodic", bc_y: str = "periodic",
                  w_prob_cap: float = 0.95, rho_new=None):
    """RK3 scalar advection with the PD limiter on the final stage."""
    return _rk3(advect_pd, q, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
                h_order, v_order, bc_x, bc_y, w_prob_cap, rho_new)


def rk3_advect_mono(q, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
                    h_order: int = 5, v_order: int = 3,
                    bc_x: str = "periodic", bc_y: str = "periodic",
                    w_prob_cap: float = 0.95, rho_new=None):
    """RK3 scalar advection with the monotonic limiter on the final stage."""
    return _rk3(advect_mono, q, rho_u, rho_v, rho_w, rho, dt, rdx, rdy, rdz,
                h_order, v_order, bc_x, bc_y, w_prob_cap, rho_new)


def capture_outflow_probs(q, fx, fy, fz, rho, dt, rdx, rdy, rdz,
                          w_prob_cap: float = 0.95, q_eps: float = 1e-30):
    """Convert total face fluxes to per-cell outflow fractions (outflow-only
    sign selection, w-face cap, renormalization when the total exceeds 1)."""
    cell_mass_rate = _as_col(rho) * torch.clamp(q, min=q_eps) / dt
    inv = 1.0 / cell_mass_rate

    xm = torch.clamp(-fx, min=0.0) * rdx * inv
    xp = torch.clamp(shift(fx, 1, AXIS_X), min=0.0) * rdx * inv
    ym = torch.clamp(-fy, min=0.0) * rdy * inv
    yp = torch.clamp(shift(fy, 1, AXIS_Y), min=0.0) * rdy * inv
    rdz_c = rdz.reshape(-1, 1, 1)
    zm = torch.clamp(-fz[..., :-1, :, :], min=0.0) * rdz_c * inv
    zp = torch.clamp(fz[..., 1:, :, :], min=0.0) * rdz_c * inv

    zm = torch.clamp(zm, max=w_prob_cap)
    zp = torch.clamp(zp, max=w_prob_cap)
    total = xm + xp + ym + yp + zm + zp
    fac = torch.where(total > 1.0, 1.0 / torch.clamp(total, min=1e-30), 1.0)
    zero_q = q <= q_eps
    fix = lambda p: torch.where(zero_q, 0.0, torch.clamp(p * fac, 0.0, 1.0))
    return OutflowProbs(xm=fix(xm), xp=fix(xp), ym=fix(ym), yp=fix(yp),
                        zm=fix(zm), zp=fix(zp))
