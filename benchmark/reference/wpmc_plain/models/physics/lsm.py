"""Land-surface models: the slab force-restore LSM (sf_surface_physics=1)
and the Noah-class 4-layer LSM (sf_surface_physics=2).

Port of ``wrf_partmc_tpu/models/physics/lsm.py``.  The Noah step solves
the surface energy balance for the skin temperature by Newton iteration,
diffuses heat through the four soil layers implicitly (one tridiagonal
system per column through ``ops.tridiag.solve``, kernel K1 on CUDA), and
moves soil water by Clapp-Hornberger diffusion, gravity drainage and the
evaporation sinks.  Vegetation and soil parameters come from the category
tables of :mod:`.landuse`.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from ... import constants as c
from ...ops.tridiag import solve as tridiag_solve
from .landuse import DEFAULT_ISLTYP, DEFAULT_IVGTYP, noah_params, soil_params
from .thermo import saturation_mixing_ratio

STEFAN = 5.670e-8          # W m-2 K-4
C_SLAB = 8.0e4             # slab areal heat capacity [J m-2 K-1]
TAU_RESTORE = 86400.0      # force-restore period [s]
EMISS = 0.98               # surface emissivity
MOIST_AVAIL = 0.3          # soil moisture availability (mavail)

DZS = (0.10, 0.30, 0.60, 1.00)       # Noah soil layer thicknesses [m]
THETA_SAT = 0.45                     # loam-class porosity (fallback default)
C_WATER = 4.18e6
W_ROOT = (0.0, 0.5, 0.5, 0.0)        # transpiration weights of the layers


@functools.lru_cache(maxsize=None)
def _column(values: tuple, device) -> torch.Tensor:
    """A constant [len, 1, 1] float32 column, made once per device."""
    return torch.tensor(values, dtype=torch.float32, device=device).reshape(-1, 1, 1)


@dataclass(frozen=True)
class LandState:
    tsk: torch.Tensor       # [ny, nx] skin temperature [K]
    t_deep: torch.Tensor    # [ny, nx] deep-soil (restore) temperature [K]


def init_land(ny: int, nx: int, t0: float = 288.0, device="cpu") -> LandState:
    f = torch.full((ny, nx), t0, dtype=torch.float32, device=device)
    return LandState(tsk=f, t_deep=f)


def slab_lsm_step(land: LandState, sw_dn, lw_dn, temp1, qv1, rho1, ustar,
                  exner_sfc, th1, dt, albedo=0.2, mavail=MOIST_AVAIL) -> tuple:
    """One force-restore step.  Returns (new LandState, fluxes dict(hfx,
    qfx_w, grf, rnet))."""
    tsk = land.tsk
    ch = 0.1 * ustar + 1.0e-3
    th_sk = tsk / exner_sfc
    hfx = rho1 * c.CP * ch * (th_sk - th1)
    qsat_sk = saturation_mixing_ratio(tsk, 1.0e5 * exner_sfc ** (1.0 / c.KAPPA))
    qfx = mavail * rho1 * ch * torch.clamp(qsat_sk - qv1, min=0.0)
    le = c.WATER_LATENT_HEAT * qfx
    lw_up = EMISS * STEFAN * tsk ** 4
    rnet = (1.0 - albedo) * sw_dn + EMISS * lw_dn - lw_up
    grf = (2.0 * torch.pi / TAU_RESTORE) * C_SLAB * (tsk - land.t_deep)
    tsk_new = torch.clamp(tsk + dt * (rnet - hfx - le - grf) / C_SLAB, 200.0, 340.0)
    t_deep_new = land.t_deep + dt * (tsk_new - land.t_deep) / TAU_RESTORE
    return (dataclasses.replace(land, tsk=tsk_new, t_deep=t_deep_new),
            dict(hfx=hfx, qfx_w=qfx, grf=grf, rnet=rnet))


@dataclass(frozen=True)
class NoahState:
    tsk: torch.Tensor       # [ny, nx] skin temperature [K]
    t_soil: torch.Tensor    # [4, ny, nx] soil layer temperatures [K]
    smois: torch.Tensor     # [4, ny, nx] volumetric soil moisture [m3/m3]
    tbot: torch.Tensor      # [ny, nx] deep boundary temperature [K]
    ivgtyp: torch.Tensor    # [ny, nx] int32 USGS land-use category (1-based)
    isltyp: torch.Tensor    # [ny, nx] int32 STAS soil-texture category (1-based)


def init_noah(ny: int, nx: int, t0: float = 288.0, tbot: float = 285.0,
              sm0: float | None = 0.25, ivgtyp=None, isltyp=None,
              device="cpu") -> NoahState:
    """Soil-column init: temperatures interpolated from the skin toward the
    deep boundary; moisture uniform at ``sm0``, or at 80% of the texture
    class's field capacity when ``sm0=None``."""
    dzs = torch.tensor(DZS, dtype=torch.float32)
    depth = torch.cumsum(dzs, 0) - 0.5 * dzs
    frac = (depth / (depth[-1] + 0.5 * DZS[-1])).reshape(-1, 1, 1)
    t_soil = (t0 + (tbot - t0) * frac).expand(4, ny, nx).to(device).contiguous()
    full = lambda v, dtype: torch.full((ny, nx), v, dtype=dtype, device=device)
    iv = (full(DEFAULT_IVGTYP, torch.int32) if ivgtyp is None
          else torch.as_tensor(ivgtyp, dtype=torch.int32, device=device))
    isl = (full(DEFAULT_ISLTYP, torch.int32) if isltyp is None
           else torch.as_tensor(isltyp, dtype=torch.int32, device=device))
    if sm0 is None:
        smois = (soil_params(isl)["theta_fc"] * 0.8).expand(4, ny, nx).contiguous()
    else:
        smois = torch.full((4, ny, nx), sm0, dtype=torch.float32, device=device)
    return NoahState(tsk=full(t0, torch.float32), t_soil=t_soil, smois=smois,
                     tbot=full(tbot, torch.float32), ivgtyp=iv, isltyp=isl)


def _soil_conductivity(theta, theta_sat=THETA_SAT):
    """Johansen-class thermal conductivity [W/m/K] vs moisture."""
    ke = torch.clamp(torch.log10(torch.clamp(theta / theta_sat, min=0.1)) + 1.0,
                     0.0, 1.0)
    return 0.15 + (1.9 - 0.15) * ke


def noah_lsm_step(land: NoahState, sw_dn, lw_dn, temp1, qv1, rho1, ustar,
                  exner_sfc, th1, dt, albedo=None, precip=0.0,
                  season: str = "summer") -> tuple:
    """One Noah-class step, with the call contract of :func:`slab_lsm_step`
    (+ ``precip`` [kg m-2 s-1] infiltration).  ``albedo`` overrides the
    table value when given.  Returns (new NoahState, fluxes dict)."""
    p = noah_params(land.ivgtyp, land.isltyp, season)
    theta_sat, theta_fc, theta_wilt = p["theta_sat"], p["theta_fc"], p["theta_wilt"]
    b_ch, k_sat, psi_sat = p["b_ch"], p["k_sat"], p["psi_sat"]
    veg_frac, rsmin, lai = p["veg_frac"], p["rsmin"], p["lai"]
    emiss = p["emiss"]
    albedo = p["albedo"] if albedo is None else albedo

    dzs = _column(DZS, land.smois.device)
    theta = torch.minimum(torch.clamp(land.smois, min=0.02), theta_sat)
    kappa = _soil_conductivity(theta, theta_sat)
    c_soil = (1.0 - theta_sat) * p["c_dry"] + theta * C_WATER

    # evaporative partition
    ch = 0.1 * ustar + 1.0e-3
    beta1 = torch.clamp((theta[0] - theta_wilt) / (theta_fc - theta_wilt), 0.0, 1.0)
    root = (theta[1] * DZS[1] + theta[2] * DZS[2]) / (DZS[1] + DZS[2])
    beta_rz = torch.clamp((root - theta_wilt) / (theta_fc - theta_wilt), 0.05, 1.0)
    f_sw = sw_dn / (sw_dn + 100.0)
    r_c = rsmin / (torch.clamp(lai, min=0.1) * torch.clamp(f_sw * beta_rz, min=0.05))
    r_a = 1.0 / torch.clamp(ch, min=1e-5)

    # skin temperature: Newton iterations of the surface energy balance
    tsk = land.tsk
    p_sfc = 1.0e5 * exner_sfc ** (1.0 / c.KAPPA)
    g_coef = kappa[0] / (0.5 * DZS[0])

    def fluxes(tsk):
        qsat = saturation_mixing_ratio(tsk, p_sfc)
        e_dir = (1.0 - veg_frac) * beta1 * rho1 * ch * torch.clamp(qsat - qv1, min=0.0)
        e_t = veg_frac * rho1 / (r_a + r_c) * torch.clamp(qsat - qv1, min=0.0)
        hfx = rho1 * c.CP * ch * (tsk / exner_sfc - th1)
        g_flx = g_coef * (tsk - land.t_soil[0])
        return qsat, e_dir, e_t, hfx, g_flx

    for _ in range(3):
        qsat, e_dir, e_t, hfx, g_flx = fluxes(tsk)
        dqsat = qsat * c.WATER_LATENT_HEAT / (461.5 * tsk ** 2)
        le = c.WATER_LATENT_HEAT * (e_dir + e_t)
        lw_up = emiss * STEFAN * tsk ** 4
        f = (1.0 - albedo) * sw_dn + emiss * lw_dn - lw_up - hfx - le - g_flx
        dfdt = -(4.0 * emiss * STEFAN * tsk ** 3
                 + rho1 * c.CP * ch / exner_sfc
                 + c.WATER_LATENT_HEAT * rho1
                 * ((1.0 - veg_frac) * beta1 * ch + veg_frac / (r_a + r_c)) * dqsat
                 + g_coef)
        tsk = torch.clamp(tsk - f / dfdt, 200.0, 340.0)
    _, e_dir, e_t, hfx, g_flx = fluxes(tsk)
    qfx = e_dir + e_t

    # implicit soil heat diffusion: the solved G as top flux, a fixed deep
    # boundary temperature ~8 m down
    k_int = 0.5 * (kappa[1:] + kappa[:-1])
    dz_int = 0.5 * (dzs[1:] + dzs[:-1])
    flux_c = k_int / dz_int                             # [3, ny, nx]
    zrow = torch.zeros_like(flux_c[:1])
    hb = kappa[3:] / (0.5 * dzs[3:] + 4.0)
    lo = torch.cat([zrow, flux_c], dim=0)
    hi = torch.cat([flux_c, hb], dim=0)
    alpha = dt / (c_soil * dzs)
    dl = -alpha * lo
    du = -alpha * hi
    d = 1.0 - dl - du
    rhs = land.t_soil + alpha * torch.cat([g_flx[None], torch.zeros_like(flux_c)], dim=0)
    rhs = torch.cat([rhs[:3], rhs[3:] + alpha[3:] * hb * land.tbot], dim=0)
    t_soil = tridiag_solve(dl.contiguous(), d.contiguous(), du.contiguous(),
                           rhs.contiguous())

    # soil moisture: Clapp-Hornberger diffusion + gravity drainage,
    # evaporation sinks, infiltration
    rel = theta / theta_sat
    diff = (b_ch * k_sat * psi_sat / theta_sat) * rel ** (b_ch + 2.0)
    k_hyd = k_sat * rel ** (2.0 * b_ch + 3.0)
    d_int = 0.5 * (diff[1:] + diff[:-1])
    q_diff = d_int * (theta[:-1] - theta[1:]) / dz_int
    q_net = q_diff + 0.5 * (k_hyd[1:] + k_hyd[:-1])     # + gravity drainage
    infil = torch.full_like(q_net[:1], float(torch.tensor(precip, dtype=torch.float32)
                                             / 1000.0))
    inflow = torch.cat([infil, q_net], dim=0)
    outflow = torch.cat([q_net, k_hyd[3:]], dim=0)
    sink_e = _column(W_ROOT, dzs.device) * e_t[None] / 1000.0
    sink_e = torch.cat([(e_dir / 1000.0)[None], sink_e[1:]], dim=0)
    smois = torch.minimum(
        torch.clamp(theta + dt * (inflow - outflow - sink_e) / dzs, min=0.02), theta_sat)

    new = dataclasses.replace(land, tsk=tsk, t_soil=t_soil, smois=smois)
    rnet = (1.0 - albedo) * sw_dn + emiss * lw_dn - emiss * STEFAN * tsk ** 4
    return new, dict(hfx=hfx, qfx_w=qfx, grf=g_flx, rnet=rnet)
