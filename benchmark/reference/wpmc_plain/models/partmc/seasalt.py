"""Sea-salt surface emissions.

Port of ``wrf_partmc_tpu/models/partmc/seasalt.py``: the Gong (2003)
whitecap source function (``seasalt_param=1``) and its Ovadnevaite-style
high-wind scaling (``=2``), integrated over a fixed log radius grid, and a
fixed-slot particle sample per cell whose bins are drawn by
``rng.categorical`` over the bins' log fluxes, the draw
``jax.random.categorical`` makes in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import rng
from .aero_data import AeroData, diam_to_vol


def gong03_dFdr(r_um, u10):
    """Number flux spectrum dF/dr [# m-2 s-1 um-1] at 80% RH radius r [um]
    (Gong 2003 eq. 2, Theta = 30)."""
    r = r_um
    theta = 30.0
    A = 4.7 * (1.0 + theta * r) ** (-0.017 * r ** -1.44)
    B = (0.433 - torch.log10(r)) / 0.433
    return (1.373 * u10 ** 3.41 * r ** (-A)
            * (1.0 + 0.057 * r ** 3.45)
            * 10.0 ** (1.607 * torch.exp(-(B ** 2))))


def seasalt_number_fluxes(u10, n_bins: int = 8, r_min=0.05, r_max=5.0,
                          param: int = 1):
    """Integrated number flux per log-radius bin.  ``u10`` [...] tensor.
    Returns (r_centers_um [B], flux [..., B] [# m-2 s-1])."""
    edges = np.logspace(np.log10(r_min), np.log10(r_max), n_bins + 1)
    centers = torch.tensor(np.sqrt(edges[:-1] * edges[1:]), dtype=torch.float32,
                           device=u10.device)
    widths = torch.tensor(np.diff(edges), dtype=torch.float32, device=u10.device)
    u = u10[..., None]
    flux = gong03_dFdr(centers, u) * widths
    if param == 2:   # stronger wind dependence at high u10
        flux = flux * torch.clamp((u / 9.0) ** 0.5, 0.3, 3.0)
    return centers, flux


def sample_seasalt(key, aero_data: AeroData, u10, area, dt, n_slots: int,
                   cell_shape=(), param: int = 1, source: int = 0,
                   w_class: int = 0, w_class_spume: int | None = None,
                   r80_split_um: float = 10.0, block=None):
    """Fixed-slot sea-salt sample: ``n_slots`` entries per cell, pure Na+Cl
    (0.4/0.6 by volume) at dry diameter r80, each carrying an equal share of
    the cell's integrated number flux times ``area`` and ``dt``.  With
    ``w_class_spume`` entries with r80 >= ``r80_split_um`` take that class.
    Returns (vol [..., S, E], num [..., E], source, w_class) for
    ``add_particles``.  ``block``: a rank's block of a global draw
    (``rng.Block``)."""
    centers_um, flux = seasalt_number_fluxes(u10, param=param)   # [..., B]
    B = centers_um.shape[0]
    E = n_slots
    total = torch.sum(flux, dim=-1) * area * dt                   # [...] number
    logits = torch.log(torch.clamp(flux, min=1e-30))
    logits = logits[..., None, :].expand(*cell_shape, E, B)
    b_idx = rng.categorical(key, logits, axis=-1, block=block)   # [..., E]
    r80_um = centers_um[b_idx]
    d_dry = (r80_um / 2.0) * 2.0 * 1e-6                           # [m]
    pvol = diam_to_vol(d_dry)
    vol = torch.zeros((*cell_shape, E, aero_data.n_spec), dtype=torch.float32,
                      device=u10.device)
    vol[..., aero_data.spec_by_name("Na")] = 0.4 * pvol
    vol[..., aero_data.spec_by_name("Cl")] = 0.6 * pvol
    vol = vol.transpose(-1, -2)                                   # [..., S, E]
    num = (total / E)[..., None].expand(*cell_shape, E).float()
    src = torch.full((*cell_shape, E), source, dtype=torch.int32, device=u10.device)
    if w_class_spume is None:
        wcl = torch.full((*cell_shape, E), w_class, dtype=torch.int32,
                         device=u10.device)
    else:
        wcl = torch.where(r80_um >= r80_split_um, w_class_spume, w_class).to(torch.int32)
    return vol, num, src, wcl
