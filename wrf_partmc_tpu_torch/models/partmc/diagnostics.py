"""Gridded aerosol diagnostics.

Port of ``wrf_partmc_tpu/models/partmc/diagnostics.py``, the reference's
``partmc_process`` suite: binned number and mass distributions, bulk mass
per species, the mixing-state metrics chi, D_alpha and D_gamma (Riemer and
West 2013), CCN spectra, PM1/PM2.5/PM10, and with ``advanced`` the optical
coefficients of the population and of its internally mixed
counterfactual.  Binning sums by ``scatter_add_`` and gathers by index
(``bin_grid``), where the reference contracts one-hot [..., P, B] arrays.

Empty cells keep the reference's values: its ``max(x, 1e-300)`` floors
are ``max(x, 0)`` in float32, so a cell with no particle gives 0/0 in its
mass fractions, a NaN D_alpha, D_gamma = 1 and chi = 1 (as for the
empty-background dist of ``scenario.py``).  Dead slots give NaN per-species
fractions, which the ``p > 0`` masks drop; the logarithm only sees the
masked values, so no 0 * -inf is formed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .aero_data import AeroData, particle_mass
from .aero_state import AeroState
from .bin_grid import BinGrid, bin_index, histogram
from .condense import ccn_conc, equilib_water
from .env_state import EnvState
from .optics import scat_abs_coeffs


@dataclass(frozen=True)
class AeroDiagnostics:
    num_dist: torch.Tensor      # [..., B] dN/dlnD [# m-3]
    mass_dist: torch.Tensor     # [..., B] dM/dlnD [kg m-3]
    spec_mass: torch.Tensor     # [..., S] bulk mass conc per species [kg m-3]
    num_conc: torch.Tensor      # [...] total number conc [# m-3]
    chi: torch.Tensor           # [...] mixing-state index [0-1]
    d_alpha: torch.Tensor       # [...] average particle species diversity
    d_gamma: torch.Tensor       # [...] bulk species diversity
    chi_sub: torch.Tensor       # [...] chi of the submicron (D_dry <= 1 um) cut
    ccn: torch.Tensor           # [..., K] CCN conc at the supersaturations
    pm1: torch.Tensor           # [...] [kg m-3]
    pm25: torch.Tensor
    pm10: torch.Tensor
    # advanced: bulk scattering/absorption [m-1] of the population and of
    # its internally mixed counterfactual, and the latter's CCN spectrum
    b_scat: torch.Tensor
    b_abs: torch.Tensor
    b_scat_mix: torch.Tensor
    b_abs_mix: torch.Tensor
    ccn_mix: torch.Tensor       # [..., K]


def _entropy_terms(p):
    """p log p where p > 0, else 0 (the log sees only positive values)."""
    pos = p > 0
    return torch.where(pos, p * torch.log(torch.where(pos, p, 1.0)), 0.0)


def mixing_state_metrics(state: AeroState, aero_data: AeroData,
                         group_masks=None, particle_mask=None):
    """(chi, D_alpha, D_gamma) per cell from dry per-species masses.
    ``group_masks`` ([G, S] 0/1) aggregates species into surrogate groups
    first; ``particle_mask`` ([..., P] 0/1) restricts the population (the
    size-cut variants)."""
    mass_sp = state.vol * aero_data.density[:, None] * aero_data.dry_mask[:, None]
    if group_masks is not None:
        gm = torch.as_tensor(group_masks, dtype=mass_sp.dtype, device=mass_sp.device)
        mass_sp = torch.einsum("gs,...sp->...gp", gm, mass_sp)
    num = state.num
    if particle_mask is not None:
        num = num * torch.as_tensor(particle_mask, device=num.device).to(num.dtype)
    mass_a = torch.sum(mass_sp, dim=-2)                          # [..., P]
    mu_tot = torch.sum(mass_a * num, dim=-1)                     # [...]
    floor = lambda x: torch.clamp(x, min=0.0)                    # 1e-300 is 0 in f32
    p_i = mass_a * num / floor(mu_tot[..., None])
    p_ia = mass_sp / floor(mass_a[..., None, :])
    H_i = -torch.sum(_entropy_terms(p_ia), dim=-2)
    d_alpha = torch.exp(torch.sum(p_i * H_i, dim=-1))
    P_a = torch.sum(mass_sp * num[..., None, :], dim=-1) / floor(mu_tot[..., None])
    d_gamma = torch.exp(-torch.sum(_entropy_terms(P_a), dim=-1))
    chi = (d_alpha - 1.0) / torch.clamp(d_gamma - 1.0, min=1e-10)
    chi = torch.clamp(torch.where(d_gamma > 1.0 + 1e-6, chi, 1.0), 0.0, 1.0)
    return chi, d_alpha, d_gamma


def pm_mass(state: AeroState, aero_data: AeroData, cutoff_diam, cell_volume):
    """Dry mass conc [kg m-3] of the particles with dry diameter at most
    ``cutoff_diam``."""
    d = state.dry_diameter(aero_data)
    m = particle_mass(state.vol, aero_data, dry=True)
    sel = (d <= cutoff_diam) & state.alive
    return torch.sum(torch.where(sel, m * state.num, 0.0), dim=-1) / cell_volume


def bin_average_comp(state: AeroState, aero_data: AeroData, bg: BinGrid) -> AeroState:
    """The internally mixed counterfactual: every particle's dry composition
    becomes its size bin's number-weighted mean composition by volume, each
    particle keeping its dry volume; water is zeroed (re-equilibrate before
    optics or CCN)."""
    idx = bin_index(bg, state.dry_diameter(aero_data))            # [..., P]
    S = state.vol.shape[-2]
    idx_s = idx[..., None, :].expand(*idx.shape[:-1], S, idx.shape[-1])
    w = torch.where(state.alive, state.num, 0.0)
    dry_vol_sp = state.vol * aero_data.dry_mask[:, None]          # [..., S, P]
    v_sb = torch.zeros((*state.vol.shape[:-1], bg.n_bin), dtype=state.vol.dtype,
                       device=state.vol.device)
    v_sb.scatter_add_(-1, idx_s, dry_vol_sp * w[..., None, :])   # [..., S, B]
    v_b = torch.sum(v_sb, dim=-2)
    frac_sb = v_sb / torch.clamp(v_b[..., None, :], min=1e-30)
    frac_p = torch.gather(frac_sb, -1, idx_s)                     # [..., S, P]
    vol_new = frac_p * torch.sum(dry_vol_sp, dim=-2)[..., None, :]
    return dataclasses.replace(state, vol=vol_new)


def process(state: AeroState, aero_data: AeroData, env: EnvState, bg: BinGrid,
            supersats=(0.001, 0.003, 0.006, 0.01),
            advanced: bool = True) -> AeroDiagnostics:
    """Every gridded diagnostic in one pass; ``advanced`` adds the optical
    and internally-mixed counterfactual fields (zeros when off)."""
    V = env.cell_volume
    d = torch.where(state.alive, state.dry_diameter(aero_data), bg.centers[0])
    w_num = state.num / V[..., None]
    m = particle_mass(state.vol, aero_data, dry=True)
    num_dist = histogram(bg, d, w_num) / bg.log_width
    mass_dist = histogram(bg, d, w_num * m) / bg.log_width
    spec_mass = torch.einsum("...sp,...p->...s", state.vol * aero_data.density[:, None],
                             w_num)
    chi, d_alpha, d_gamma = mixing_state_metrics(state, aero_data)
    chi_sub, _, _ = mixing_state_metrics(state, aero_data,
                                         particle_mask=(d <= 1e-6) & state.alive)
    ss = torch.tensor(supersats, dtype=torch.float32, device=V.device)
    ccn = ccn_conc(state, aero_data, env, ss)
    if advanced:
        b_scat, b_abs = scat_abs_coeffs(state, aero_data, V)
        mixed = equilib_water(bin_average_comp(state, aero_data, bg), aero_data, env)
        b_scat_mix, b_abs_mix = scat_abs_coeffs(mixed, aero_data, V)
        ccn_mix = ccn_conc(mixed, aero_data, env, ss)
    else:
        zero = torch.zeros_like(chi)
        b_scat = b_abs = b_scat_mix = b_abs_mix = zero
        ccn_mix = torch.zeros_like(ccn)
    return AeroDiagnostics(
        num_dist=num_dist, mass_dist=mass_dist, spec_mass=spec_mass,
        num_conc=state.total_num() / V, chi=chi, d_alpha=d_alpha, d_gamma=d_gamma,
        chi_sub=chi_sub, ccn=ccn,
        pm1=pm_mass(state, aero_data, 1e-6, V),
        pm25=pm_mass(state, aero_data, 2.5e-6, V),
        pm10=pm_mass(state, aero_data, 1e-5, V),
        b_scat=b_scat, b_abs=b_abs, b_scat_mix=b_scat_mix, b_abs_mix=b_abs_mix,
        ccn_mix=ccn_mix)
