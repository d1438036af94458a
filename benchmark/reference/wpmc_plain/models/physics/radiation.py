"""Radiation: Dudhia-class and correlated-k shortwave, gray and
correlated-k longwave, with the PartMC aerosol direct effect and the
aerosol attenuation of photolysis.

Port of ``wrf_partmc_tpu/models/physics/radiation.py``.  Every array is
whole-domain [nz, ny, nx] (k = 0 the surface layer) and columns are
vectorized; the longwave's emission-absorption sweeps, a ``lax.scan`` in
the reference, are Python loops over levels.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import constants as c

SOLAR_CONST = 1361.0          # [W m-2]
# solar spectral weights of the 4 coupled aerosol bands (0.3/0.4/0.6/1.0 um)
BAND_WEIGHTS = (0.12, 0.28, 0.35, 0.25)
STEFAN = 5.670374e-8


def _as_tensor(x, like):
    """``x`` as a float32 tensor.  Numbers and 0-d tensors stay where they
    are (a 0-d CPU tensor is a scalar operand on any device, with no copy);
    fields go to ``like``'s device."""
    t = torch.as_tensor(x, dtype=torch.float32)
    return t if t.dim() == 0 else t.to(like.device)


def _cum_above(t_layer):
    """Product of the layer transmissions above each layer (1 at the top)."""
    t_rev = t_layer.flip(0)
    return torch.cat([torch.ones_like(t_rev[:1]),
                      torch.cumprod(t_rev, dim=0)[:-1]], dim=0).flip(0)


def _sweep(Bsrc, eps, start):
    """Emission-absorption sweep over the leading axis: F_k = F_{k-1}
    (1 - eps_k) + eps_k B_k from ``start``; returns every F_k."""
    out = []
    f = start
    for k in range(eps.shape[0]):
        f = f * (1.0 - eps[k]) + eps[k] * Bsrc[k]
        out.append(f)
    return torch.stack(out)


def _h2o_path(qv, rho, dz):
    """Water vapor path [kg m-2] from the model top down to each layer
    centre; dz: [nz]."""
    w_layer = qv * rho * dz.reshape(-1, 1, 1)
    from_top = torch.cumsum(w_layer.flip(0), dim=0).flip(0)
    return from_top - 0.5 * w_layer


def _h2o_absorption(path_mag):
    """Broadband SW water-vapor absorptance (Lacis & Hansen 1974 form)."""
    y = torch.clamp(path_mag, min=1e-10)
    return 2.9 * y / ((1.0 + 141.5 * y) ** 0.635 + 5.925 * y)


def _aerosol_band(qv, tauaer, waer, gaer, b, mu_c):
    if tauaer is None:
        z = torch.zeros_like(qv)
        return z, z, z
    return tauaer[b] / mu_c, waer[b], gaer[b]


def shortwave(qv, rho, dz, cosz, albedo, tauaer=None, waer=None, gaer=None):
    """Dudhia-class downward SW with the aerosol direct effect.  Returns
    (heat_rate [K/s], sw_sfc_down [ny, nx])."""
    mu = torch.clamp(_as_tensor(cosz, qv), min=0.0)
    mu_c = torch.clamp(mu, min=1e-3)
    s0 = SOLAR_CONST * mu
    dzc = dz.reshape(-1, 1, 1)
    wpath = _h2o_path(qv, rho, dz) / mu_c
    w_layer = qv * rho * dzc / mu_c
    dabs_h2o = torch.clamp(_h2o_absorption(wpath + w_layer) - _h2o_absorption(wpath),
                           min=0.0)
    tau_ray = 0.05 * (rho * dzc / torch.clamp((rho * dzc).sum(0), min=1e-10))
    alb = _as_tensor(albedo, qv)
    heat = torch.zeros_like(qv)
    sfc = torch.zeros(torch.broadcast_shapes(mu.shape, qv.shape[1:]),
                      dtype=torch.float32, device=qv.device)
    for b, wt in enumerate(BAND_WEIGHTS):
        ta, w0, g = _aerosol_band(qv, tauaer, waer, gaer, b, mu_c)
        tr = tau_ray / mu_c
        att = 1.0 - torch.exp(-(ta + tr))
        aer_abs = att * (1.0 - w0) * ta / torch.clamp(ta + tr, min=1e-30)
        back = att * (w0 * ta * 0.5 * (1.0 - g) + 0.5 * tr) \
            / torch.clamp(ta + tr, min=1e-30)
        t_layer = 1.0 - aer_abs - back
        flux_in = s0 * wt * _cum_above(t_layer)
        heat = heat + flux_in * (aer_abs + dabs_h2o * t_layer)
        sfc = sfc + flux_in[0] * t_layer[0]
        up = sfc * 0.0 + flux_in[0] * t_layer[0] * alb
        heat = heat + up * (aer_abs + dabs_h2o * t_layer) * 0.5
    heat_rate = heat / (rho * c.CP * dzc)
    return heat_rate, sfc * (1.0 - alb)


def longwave(temp, qv, rho, dz, t_sfc, emis_sfc=0.98):
    """Gray-emissivity broadband LW.  Returns (heat_rate [K/s],
    lw_sfc_down [ny, nx], olr [ny, nx])."""
    dzc = dz.reshape(-1, 1, 1)
    w_layer = qv * rho * dzc
    eps = 1.0 - torch.exp(-(0.33 * w_layer ** 0.5 + 5.0e-5 * rho * dzc))
    B = STEFAN * temp ** 4
    B_sfc = emis_sfc * STEFAN * _as_tensor(t_sfc, temp) ** 4
    f_dn = _sweep(B.flip(0), eps.flip(0), torch.zeros_like(B[0])).flip(0)
    f_up = _sweep(B, eps, B_sfc)
    f_dn_top = torch.cat([f_dn[1:], torch.zeros_like(B[:1])], dim=0)
    f_up_bot = torch.cat([B_sfc[None], f_up[:-1]], dim=0)
    net_in = (f_dn_top - f_dn) + (f_up_bot - f_up)
    return net_in / (rho * c.CP * dzc), f_dn[0], f_up[-1]


# RRTMG-class correlated-k longwave (ra_physics=4): 4 bands x 3 g-points of
# calibrated H2O k-values, a CO2 15 um k-distribution in band 2 and a window
# self-continuum in band 3

_LW_BANDS = ((10.0, 560.0), (560.0, 800.0), (800.0, 1250.0), (1250.0, 2600.0))
_KW = ((2.4, 0.14, 0.005), (0.10, 0.008, 0.0008), (0.02, 0.002, 1e-4),
       (4.5, 0.30, 0.012))
_GW = (0.45, 0.35, 0.20)
_K_CO2_G = (300.0, 8.0, 0.25)
_K_CONT = 1.5            # window self-continuum k, scaled by e/p0
_DIFFUS = 1.66
_CO2_PPM = 410.0


def _band_quadrature():
    """Per band the 8 midpoints and widths [m-1] of the Planck quadrature,
    float32 as the reference's ``jnp.linspace`` gives them."""
    out = []
    for lo, hi in _LW_BANDS:
        x = np.linspace(lo * 100.0, hi * 100.0, 9, dtype=np.float32)
        out.append(((0.5 * (x[1:] + x[:-1])).astype(np.float32),
                    (x[1:] - x[:-1]).astype(np.float32)))
    return out


def _planck_band_fracs(temp):
    """Per band, the fraction of sigma T^4 in it (8-point quadrature)."""
    h_c_k = 1.4388e-2      # hc/kB [m K]
    tot = torch.zeros_like(temp)
    fr = []
    for xm, dx in _band_quadrature():
        b = torch.zeros_like(temp)
        for i in range(8):
            u = float(np.float32(h_c_k) * xm[i]) / temp
            x3 = xm[i] * (xm[i] * xm[i])               # float32, as integer_pow
            b = b + float(dx[i] * x3) / torch.expm1(torch.clamp(u, 1e-3, 80.0))
        fr.append(b)
        tot = tot + b
    return [f / torch.clamp(tot, min=1e-30) for f in fr]


def longwave_kdist(temp, qv, rho, dz, t_sfc, emis_sfc=0.98):
    """Correlated-k multi-band clear-sky LW.  Returns (heat_rate [K/s],
    lw_sfc_down, olr)."""
    dzc = dz.reshape(-1, 1, 1) if dz.dim() == 1 else dz
    u_w = qv * rho * dzc
    u_c = _CO2_PPM * 1e-6 * (44.0 / 28.97) * rho * dzc
    p_over = torch.cumsum((rho * dzc).flip(0), dim=0).flip(0) * c.GRAV
    pfac = torch.clamp((p_over / 1.0e5) ** 0.8, 0.02, 1.0)
    e_scale = qv * rho * 461.5 * temp / 1.0e5

    t_sfc = _as_tensor(t_sfc, temp)
    fr = _planck_band_fracs(temp)
    fr_sfc = _planck_band_fracs(t_sfc)
    B = STEFAN * temp ** 4
    B_sfc = emis_sfc * STEFAN * t_sfc ** 4

    heat = torch.zeros_like(temp)
    lw_dn = torch.zeros_like(B[0])
    olr = torch.zeros_like(B[0])
    for b_i, kws in enumerate(_KW):
        for g_i, gw in enumerate(_GW):
            tau = _DIFFUS * kws[g_i] * u_w * pfac
            if b_i == 1:
                tau = tau + _DIFFUS * _K_CO2_G[g_i] * u_c * pfac
            if b_i == 2:
                tau = tau + _DIFFUS * _K_CONT * u_w * e_scale
            eps = 1.0 - torch.exp(-torch.clamp(tau, 0.0, 50.0))
            Bb = fr[b_i] * B
            Bb_sfc = fr_sfc[b_i] * B_sfc
            f_dn = _sweep((Bb * gw).flip(0), eps.flip(0), torch.zeros_like(B[0])).flip(0)
            f_up = _sweep(Bb * gw, eps, Bb_sfc * gw)
            lw_dn = lw_dn + f_dn[0]
            olr = olr + f_up[-1]
            f_dn_top = torch.cat([f_dn[1:], torch.zeros_like(B[:1])], dim=0)
            f_up_bot = torch.cat([(Bb_sfc * gw)[None], f_up[:-1]], dim=0)
            heat = heat + (f_dn_top - f_dn) + (f_up_bot - f_up)
    return heat / (rho * c.CP * dzc), lw_dn, olr


# RRTMG-class correlated-k shortwave (ra_sw_physics=4): 4 bands x 3
# g-points, Rayleigh scattering, H2O absorption, stratospheric O3 above the
# model top, and the per-band aerosol tau/w0/g

_SW_FRAC = (0.065, 0.430, 0.303, 0.202)      # solar fraction per band
_SW_RAY = (1.00, 0.115, 0.012, 0.0015)       # column Rayleigh tau per band
_KSW_W = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
          (0.03, 0.003, 0.0002), (0.2, 0.008, 0.0005))
_GSW = (0.30, 0.40, 0.30)
_K_O3 = (70.0, 5.0, 0.0, 0.0)
_O3_COLUMN = 6.4e-3          # kg m-2 (~300 DU)


def shortwave_kdist(qv, rho, dz, cosz, albedo, tauaer=None, waer=None,
                    gaer=None, o3_column=_O3_COLUMN):
    """Correlated-k multi-band clear-sky SW with the aerosol direct effect.
    Returns (heat_rate [K/s], sw_sfc_down)."""
    mu = torch.clamp(_as_tensor(cosz, qv), min=0.0)
    mu_c = torch.clamp(mu, min=1e-3)
    dzc = dz.reshape(-1, 1, 1)
    w_layer = qv * rho * dzc / mu_c
    air_layer = rho * dzc
    air_frac = air_layer / torch.clamp(air_layer.sum(0), min=1e-10)

    heat = torch.zeros_like(qv)
    sfc = torch.zeros(torch.broadcast_shapes(mu.shape, qv.shape[1:]),
                      dtype=torch.float32, device=qv.device)
    alb = _as_tensor(albedo, qv)
    for b, fb in enumerate(_SW_FRAC):
        s0_b = SOLAR_CONST * mu * fb * torch.exp(-_K_O3[b] * o3_column / mu_c)
        ta, w0, g = _aerosol_band(qv, tauaer, waer, gaer, b, mu_c)
        tr = _SW_RAY[b] * air_frac / mu_c
        att = 1.0 - torch.exp(-(ta + tr))
        ext = torch.clamp(ta + tr, min=1e-30)
        aer_abs = att * (1.0 - w0) * ta / ext
        back = att * (w0 * ta * 0.5 * (1.0 - g) + 0.5 * tr) / ext
        t_scat = 1.0 - aer_abs - back
        for gi, gw in enumerate(_GSW):
            t_gas = torch.exp(-_KSW_W[b][gi] * w_layer)
            t_layer = t_scat * t_gas
            flux_in = s0_b * gw * _cum_above(t_layer)
            absorb = aer_abs + (1.0 - t_gas) * t_scat
            heat = heat + flux_in * absorb
            sfc_b = flux_in[0] * t_layer[0]
            sfc = sfc + sfc_b
            heat = heat + sfc_b * alb * absorb * 0.5
    return heat / (rho * c.CP * dzc), sfc * (1.0 - alb)


def photolysis_aerosol_factor(tauaer, waer, gaer, cosz):
    """Per-level actinic-flux factor J_eff / J_clear in (0, 1] from the
    aerosol column above, in the UV-most band with the delta-scaled
    effective optical depth tau (1 - w0 (1 + g) / 2).  tauaer/waer/gaer:
    [n_band, nz, ny, nx]; returns [nz, ny, nx]."""
    mu = torch.clamp(_as_tensor(cosz, tauaer), min=1e-3)
    tau_eff = tauaer[0] * (1.0 - waer[0] * 0.5 * (1.0 + gaer[0]))
    above = torch.cumsum(tau_eff.flip(0), dim=0).flip(0) - 0.5 * tau_eff
    return torch.exp(-torch.clamp(above, min=0.0) / mu)


def radiation_driver(temp, qv, rho, dz, cosz, albedo=0.2, t_sfc=None,
                     optics=None, lw_scheme: str = "gray",
                     sw_scheme: str = "dudhia"):
    """Full radiation step: SW ("dudhia" or "kdist") plus LW ("gray" or
    "kdist"); ``optics`` is a BulkOptics or None; ``t_sfc`` defaults to the
    lowest layer's temperature.  Returns (theta heating rate [K/s],
    dict(sw_sfc_down, lw_sfc_down, olr))."""
    if t_sfc is None:
        t_sfc = temp[0]
    ta = wa = ga = None
    if optics is not None:
        ta, wa, ga = optics.tauaer, optics.waer, optics.gaer
    sw = shortwave_kdist if sw_scheme == "kdist" else shortwave
    sw_hr, sw_dn = sw(qv, rho, dz, cosz, albedo, ta, wa, ga)
    lw = longwave_kdist if lw_scheme == "kdist" else longwave
    lw_hr, lw_dn, olr = lw(temp, qv, rho, dz, t_sfc)
    return sw_hr + lw_hr, dict(sw_sfc_down=sw_dn, lw_sfc_down=lw_dn, olr=olr)
