"""Multi-mode aerosol size distributions and particle sampling.

Port of ``wrf_partmc_tpu/models/partmc/dist.py``: a dist is a stacked
[M]-mode struct; sampling draws a fixed number E of computational particles
per cell (mode by a categorical draw, diameter by a log-normal draw) and
splits the represented number equally across them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...utils import rng
from .aero_data import AeroData, diam_to_vol


@dataclass(frozen=True)
class AeroDist:
    """[M] stacked log-normal modes (leading time/cell dims allowed)."""

    num_conc: torch.Tensor        # [..., M] number conc per mode [# m-3]
    geom_mean_diam: torch.Tensor  # [..., M] [m]
    log_geom_std: torch.Tensor    # [..., M] ln(sigma_g)
    vol_frac: torch.Tensor        # [..., M, S]
    source: torch.Tensor          # [M] int32
    w_class: torch.Tensor         # [M] int32

    @property
    def n_mode(self) -> int:
        return self.num_conc.shape[-1]


def make_mode(num_conc, gmd, gsd, vol_frac, source=0, w_class=0,
              device="cpu") -> AeroDist:
    """Single log-normal mode (gsd = geometric std dev, not its log)."""
    a = lambda v: torch.as_tensor(np.asarray([v], np.float32), device=device)
    vf = a(vol_frac)
    return AeroDist(num_conc=a(num_conc), geom_mean_diam=a(gmd),
                    log_geom_std=torch.log(a(gsd)),
                    vol_frac=vf / torch.sum(vf),
                    source=torch.tensor([source], dtype=torch.int32, device=device),
                    w_class=torch.tensor([w_class], dtype=torch.int32, device=device))


def concat_dists(dists) -> AeroDist:
    cat = lambda f: torch.cat([getattr(d, f) for d in dists], dim=-1)
    return AeroDist(num_conc=cat("num_conc"), geom_mean_diam=cat("geom_mean_diam"),
                    log_geom_std=cat("log_geom_std"),
                    vol_frac=torch.cat([d.vol_frac for d in dists], dim=-2),
                    source=cat("source"), w_class=cat("w_class"))


def dist_number_conc(dist: AeroDist) -> torch.Tensor:
    return torch.sum(dist.num_conc, dim=-1)


def sample_particles(key, dist: AeroDist, aero_data: AeroData, n_sample: int,
                     volume, cell_shape=()):
    """Draw ``n_sample`` computational particles per cell representing the
    whole dist in physical volume ``volume`` [m3].

    Returns (vol [*cell, S, E], num [*cell, E], source [*cell, E],
    w_class [*cell, E])."""
    E = n_sample
    cs = tuple(cell_shape)
    M = dist.n_mode
    S = aero_data.n_spec
    k_mode, k_diam = rng.split(key)
    logits = torch.log(torch.clamp(dist.num_conc, min=0.0))  # 1e-300 is 0 in f32
    m_idx = rng.categorical(k_mode, logits[..., None, :].expand(*cs, E, M), axis=-1)
    take = lambda a: torch.gather(a.expand(*cs, M), -1, m_idx)
    gmd = take(dist.geom_mean_diam)
    sig = take(dist.log_geom_std)
    z = rng.normal(k_diam, (*cs, E), dist.num_conc.device)
    diam = gmd * torch.exp(sig * z)
    pvol = diam_to_vol(diam)
    vf = dist.vol_frac.expand(*cs, M, S)
    vfrac = torch.gather(vf, -2, m_idx[..., None].expand(*cs, E, S))
    vol = (vfrac * pvol[..., None]).transpose(-1, -2).contiguous()
    total = dist_number_conc(dist) * volume
    num = (total / E).to(torch.float32)[..., None].expand(*cs, E).contiguous()
    source = take(dist.source)
    w_class = take(dist.w_class)
    return vol, num, source, w_class
