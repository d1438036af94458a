"""Per-particle dry deposition (resistance-in-series).

Port of ``wrf_partmc_tpu/models/partmc/deposition.py``: the settling,
deposition velocity and aerodynamic resistance, and ``deposit_step``, the
stochastic removal from a surface-layer population with p = v_d dt / dz.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...utils import rng
from .aero_data import AeroData, particle_mass, particle_volume
from .aero_state import AeroState
from .coag import cunningham_slip
from .env_state import EnvState

_ALPHA_IMP = 1.0       # impaction shape parameter
_A_INT = 2.0e-3        # characteristic collector radius [m]
_EB_EXP = 2.0 / 3.0    # Brownian efficiency exponent


def settling_velocity(diam, rho_p, env: EnvState):
    """Stokes settling velocity with slip correction [m s-1]."""
    cc = cunningham_slip(diam, env.air_mean_free_path[..., None])
    return rho_p * diam ** 2 * c.GRAV * cc / (18.0 * c.AIR_DYN_VISC)


def deposition_velocity(diam, rho_p, env: EnvState, r_a):
    """v_d per particle given aerodynamic resistance r_a [s m-1]."""
    temp = env.temp[..., None]
    ustar = env.ustar[..., None]
    v_s = settling_velocity(diam, rho_p, env)
    cc = cunningham_slip(diam, env.air_mean_free_path[..., None])
    diff = c.BOLTZMANN * temp * cc / (3.0 * torch.pi * c.AIR_DYN_VISC * diam)
    nu = c.AIR_DYN_VISC / env.air_density[..., None]
    sc = nu / diff
    st = v_s * ustar ** 2 / (c.GRAV * nu)
    e_b = sc ** (-_EB_EXP)
    e_im = (st / (_ALPHA_IMP + st)) ** 2
    e_in = 0.5 * (diam / _A_INT) ** 2
    r_s = 1.0 / torch.clamp(3.0 * ustar * (e_b + e_im + e_in), min=1e-30)
    r_a = r_a[..., None]
    return v_s + 1.0 / (r_a + r_s + r_a * r_s * v_s)


def _psi_h(zeta):
    """Businger-Dyer integrated stability function for heat/scalars."""
    x = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** 0.25
    unstable = 2.0 * torch.log(0.5 * (1.0 + x * x))
    stable = -5.0 * torch.clamp(zeta, min=0.0)
    return torch.where(zeta < 0.0, unstable, stable)


def aerodynamic_resistance(env: EnvState, z_ref, z0=0.1, rmol=None):
    """r_a = [ln(z/z0) - psi_h(z/L) + psi_h(z0/L)] / (kappa u*); neutral log
    law without ``rmol``.  z_ref: 0-d tensor."""
    log_term = torch.log(torch.clamp(z_ref / z0, min=1.1))
    if rmol is not None:
        log_term = log_term - _psi_h(z_ref * rmol) + _psi_h(z0 * rmol)
    return torch.clamp(log_term, min=0.1) / (c.KARMAN
                                             * torch.clamp(env.ustar, min=0.01))


def deposit_step(state: AeroState, aero_data: AeroData, env: EnvState, dt, dz,
                 key, z0=0.1) -> AeroState:
    """Stochastic removal from the surface-layer cell population: each
    alive particle goes with probability clip(v_d dt / dz, 0, 1)."""
    vol = particle_volume(state.vol)
    mass = particle_mass(state.vol, aero_data)
    rho_p = mass / torch.clamp(vol, min=0.0)       # max(vol, 1e-300) is max(vol, 0) in f32
    diam = torch.clamp(state.wet_diameter(), min=1e-9)
    r_a = aerodynamic_resistance(env, env.height, z0)
    v_d = deposition_velocity(diam, rho_p, env, r_a)
    dz = torch.as_tensor(dz, dtype=torch.float32, device=diam.device)
    p_rem = torch.clamp(v_d * dt / dz[..., None], 0.0, 1.0)
    u = rng.uniform(key, state.num.shape, state.num.device)
    keep = (u >= p_rem) & state.alive
    return dataclasses.replace(
        state, num=torch.where(keep, state.num, 0.0),
        vol=torch.where(keep[..., None, :], state.vol, 0.0))
