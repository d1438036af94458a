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


def from_sampled(diam_edges, num_conc, vol_frac, source=0, w_class=0,
                 device="cpu") -> AeroDist:
    """A binned (histogram) size distribution (the reference's
    AERO_MODE_TYPE_SAMPLED): each bin becomes one narrow log-normal mode
    with the bin's mean and variance in ln D (sigma_ln = bin width /
    sqrt(12)), so the stacked-mode sampling applies unchanged.

    diam_edges: [B+1] bin edges [m]; num_conc: [B] number conc per bin
    [# m-3]; vol_frac: [S] or [B, S]."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    e = f32(diam_edges)
    nc = f32(num_conc)
    B = nc.shape[-1]
    gmd = torch.sqrt(e[:-1] * e[1:])
    sig = torch.log(e[1:] / e[:-1]) / torch.sqrt(torch.tensor(12.0, device=device))
    vf = f32(vol_frac)
    if vf.dim() == 1:
        vf = vf.expand(B, vf.shape[0])
    vf = vf / torch.clamp(torch.sum(vf, dim=-1, keepdim=True), min=1e-30)
    full = lambda v: torch.full((B,), v, dtype=torch.int32, device=device)
    return AeroDist(num_conc=nc, geom_mean_diam=gmd,
                    log_geom_std=torch.clamp(sig, min=1e-3), vol_frac=vf,
                    source=full(source), w_class=full(w_class))


def concat_dists(dists) -> AeroDist:
    cat = lambda f: torch.cat([getattr(d, f) for d in dists], dim=-1)
    return AeroDist(num_conc=cat("num_conc"), geom_mean_diam=cat("geom_mean_diam"),
                    log_geom_std=cat("log_geom_std"),
                    vol_frac=torch.cat([d.vol_frac for d in dists], dim=-2),
                    source=cat("source"), w_class=cat("w_class"))


def dist_number_conc(dist: AeroDist) -> torch.Tensor:
    return torch.sum(dist.num_conc, dim=-1)


def dist_num_density(dist: AeroDist, diam) -> torch.Tensor:
    """dN/dlnD [# m-3] at diameters ``diam[...]``: the analytic log-normal
    sum."""
    ln_d = torch.log(diam)[..., None]
    mu = torch.log(dist.geom_mean_diam)
    sig = dist.log_geom_std
    pdf = torch.exp(-0.5 * ((ln_d - mu) / sig) ** 2) / (sig * np.float32(np.sqrt(2 * np.pi)))
    return torch.sum(dist.num_conc * pdf, dim=-1)


def sample_particles(key, dist: AeroDist, aero_data: AeroData, n_sample: int,
                     volume, cell_shape=(), block=None):
    """Draw ``n_sample`` computational particles per cell representing the
    whole dist in physical volume ``volume`` [m3].  With ``block``
    (``rng.Block``), ``cell_shape`` is a rank's block of the global cells
    and the draws are the block's slice of the global draws.

    Returns (vol [*cell, S, E], num [*cell, E], source [*cell, E],
    w_class [*cell, E])."""
    E = n_sample
    cs = tuple(cell_shape)
    M = dist.n_mode
    S = aero_data.n_spec
    k_mode, k_diam = rng.split(key)
    logits = torch.log(torch.clamp(dist.num_conc, min=0.0))  # 1e-300 is 0 in f32
    m_idx = rng.categorical(k_mode, logits[..., None, :].expand(*cs, E, M), axis=-1,
                            block=block)
    take = lambda a: torch.gather(a.expand(*cs, M), -1, m_idx)
    gmd = take(dist.geom_mean_diam)
    sig = take(dist.log_geom_std)
    z = rng.normal(k_diam, (*cs, E), dist.num_conc.device, block)
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
