"""Single-column large-scale forcing.

Port of ``wrf_partmc_tpu/models/physics/scm_forcing.py``: relax u, v,
theta' and qv toward prescribed profiles with a timescale ``tau``, plus an
optional subsidence on theta' by a prescribed w.  No step of either
package calls it; it is carried so that the physics modules are complete.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ...grid import Grid
from ..dycore.state import DycoreState


@dataclass(frozen=True)
class ScmForcing:
    u_target: torch.Tensor       # [nz]
    v_target: torch.Tensor       # [nz]
    theta_target: torch.Tensor   # [nz] perturbation theta
    qv_target: torch.Tensor      # [nz]
    tau: float = 3600.0
    w_subsidence: float = 0.0


def make_scm_forcing(grid: Grid, u=5.0, v=0.0, theta_p=0.0, qv=0.0,
                     tau=3600.0, w_subsidence=0.0) -> ScmForcing:
    prof = lambda v0: torch.full((grid.nz,), v0, dtype=torch.float32,
                                 device=grid.dz.device)
    return ScmForcing(u_target=prof(u), v_target=prof(v),
                      theta_target=prof(theta_p), qv_target=prof(qv),
                      tau=tau, w_subsidence=w_subsidence)


def _gradient0(f):
    """``jnp.gradient`` along dim 0 with unit spacing: one-sided ends,
    centred interior."""
    return torch.cat([f[1:2] - f[0:1], (f[2:] - f[:-2]) / 2.0, f[-1:] - f[-2:-1]], dim=0)


def apply_scm_forcing(dyn: DycoreState, f: ScmForcing, grid: Grid,
                      dt) -> DycoreState:
    """Relaxation (+ subsidence on theta') applied after the dynamics step."""
    w = float(1.0 - torch.exp(torch.tensor(-dt / f.tau, dtype=torch.float32)))
    col = lambda a: a.reshape(-1, 1, 1)
    u = dyn.u + w * (col(f.u_target) - dyn.u)
    v = dyn.v + w * (col(f.v_target) - dyn.v)
    th = dyn.theta_p + w * (col(f.theta_target) - dyn.theta_p)
    if f.w_subsidence != 0.0:
        dthdz = _gradient0(th) / grid.dz.reshape(-1, 1, 1)
        th = th - dt * f.w_subsidence * dthdz
    moist = dyn.moist.clone()
    moist[0] = dyn.moist[0] + w * (col(f.qv_target) - dyn.moist[0])
    return dataclasses.replace(dyn, u=u, v=v, theta_p=th, moist=moist)
