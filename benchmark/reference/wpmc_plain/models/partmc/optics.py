"""Per-particle aerosol optical properties and the bulk radiation feedback.

Port of ``wrf_partmc_tpu/models/partmc/optics.py``: species refractive
indices (OPAC-class, by species class), per-particle refractive index by
volume mixing or Maxwell-Garnett BC inclusions, per-particle efficiencies
from the Mie table (``method="mie"``), its fitted surrogate (``"mie_fit"``,
the default of the bulk optics) or anomalous diffraction (``"adt"``), and
their aggregation into layer tauaer / waer / gaer at the four shortwave
bands.  The fitted path's per-cell sums run on the card through K5
(``ops/mie_fit.py``, ``mie_fit_sums``) and on the CPU through their plain
version (``mie_fit_sums_plain``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .aero_data import AeroData, particle_volume
from .aero_state import AeroState
from .mie import fit_lookup, make_mie_table, table_lookup

# the 4 shortwave bands the reference couples (tauaer1-4) [m]
WAVELENGTHS = (3.0e-7, 4.0e-7, 6.0e-7, 1.0e-6)


def _species_nk_np(names: tuple):
    n = np.full(len(names), 1.45, np.float32)
    k = np.zeros(len(names), np.float32)
    for i, name in enumerate(names):
        if name == "BC":
            n[i], k[i] = 1.82, 0.74        # soot
        elif name == "H2O":
            n[i], k[i] = 1.33, 0.0
        elif name in ("OC", "ARO1", "ARO2", "ALK1", "OLE1",
                      "API1", "API2", "LIM1", "LIM2"):
            n[i], k[i] = 1.53, 0.006       # organic carbon
        elif name in ("Na", "Cl"):
            n[i], k[i] = 1.50, 0.0         # sea salt
        elif name in ("OIN", "CO3", "Ca"):
            n[i], k[i] = 1.53, 0.008       # mineral dust-ish
        else:
            n[i], k[i] = 1.43, 0.0         # sulfate/nitrate/ammonium
    return n, k


@functools.lru_cache(maxsize=None)
def _species_nk(names: tuple, device):
    n, k = _species_nk_np(names)
    return torch.as_tensor(n, device=device), torch.as_tensor(k, device=device)


def species_refractive_index(aero_data: AeroData):
    """(n, k) tensors [S] at visible wavelengths (OPAC-class values)."""
    return _species_nk(aero_data.names, aero_data.density.device)


def particle_refractive_index(state: AeroState, aero_data: AeroData,
                              maxwell_garnett: bool = False):
    """(n, k) per particle [..., P]: the volume mixing rule, or with
    ``maxwell_garnett`` BC as spherical inclusions in the volume-mixed
    non-BC host."""
    n_s, k_s = species_refractive_index(aero_data)
    vtot = particle_volume(state.vol)
    safe = torch.clamp(vtot, min=1e-30)
    empty = vtot <= 0.0
    if not maxwell_garnett:
        n = torch.einsum("...sp,s->...p", state.vol, n_s) / safe
        k = torch.einsum("...sp,s->...p", state.vol, k_s) / safe
        return torch.where(empty, 1.45, n), torch.where(empty, 0.0, k)

    i_bc = aero_data.spec_by_name("BC")
    v_bc = state.vol[..., i_bc, :]
    f = torch.clamp(v_bc / safe, 0.0, 0.999)
    host_v = torch.clamp(vtot - v_bc, min=1e-30)
    n_h = (torch.einsum("...sp,s->...p", state.vol, n_s) - v_bc * n_s[i_bc]) / host_v
    k_h = (torch.einsum("...sp,s->...p", state.vol, k_s) - v_bc * k_s[i_bc]) / host_v
    m_h = torch.complex(n_h, k_h)
    n_np, k_np = _species_nk_np(aero_data.names)
    m_i = np.complex64(complex(float(n_np[i_bc]), float(k_np[i_bc])))
    eps_m = m_h * m_h
    eps_i = complex(m_i * m_i)                  # complex64 product
    num = eps_i + 2.0 * eps_m + 2.0 * f * (eps_i - eps_m)
    den = eps_i + 2.0 * eps_m - f * (eps_i - eps_m)
    m_eff = torch.sqrt(eps_m * num / den)
    n = torch.abs(m_eff.real)
    k = torch.abs(m_eff.imag)
    return torch.where(empty, 1.45, n), torch.where(empty, 0.0, k)


def adt_efficiencies(diam, n, k, wavelength):
    """ADT extinction/absorption efficiencies (Q_ext, Q_abs) (van de Hulst;
    Ackerman & Stephens 1987 absorbing form)."""
    x = torch.pi * diam / wavelength
    rho = 2.0 * x * torch.clamp(n - 1.0, min=1e-6)
    beta = torch.atan2(k, torch.clamp(n - 1.0, min=1e-6))
    cosb = torch.cos(beta)
    e = torch.exp(-rho * torch.tan(beta))
    q_ext = (2.0 - 4.0 * e * (cosb / rho) * torch.sin(rho - beta)
             - 4.0 * e * (cosb / rho) ** 2 * torch.cos(rho - 2.0 * beta)
             + 4.0 * (cosb / rho) ** 2 * torch.cos(2.0 * beta))
    q_ext = torch.clamp(q_ext, 0.0, 6.0)
    z = 4.0 * x * k
    q_abs = 1.0 + 2.0 * torch.exp(-z) / z + 2.0 * (torch.exp(-z) - 1.0) / (z * z)
    q_abs = torch.where(z > 1e-6, q_abs, z * 2.0 / 3.0)
    q_abs = torch.minimum(torch.clamp(q_abs, 0.0, 1.0), q_ext)
    return q_ext, q_abs


@dataclass(frozen=True)
class BulkOptics:
    tauaer: torch.Tensor    # [W, nz, ny, nx] layer optical depth per band
    waer: torch.Tensor      # [W, nz, ny, nx] single-scattering albedo
    gaer: torch.Tensor      # [W, nz, ny, nx] asymmetry parameter


def particle_efficiencies(diam, n, k, wavelength, method="mie", mie_table=None):
    """Per-particle (q_ext, q_sca, g) at one wavelength by the selected
    backend (shapes follow ``diam``)."""
    x =torch.pi * diam / wavelength
    if method == "mie":
        table = mie_table if mie_table is not None else make_mie_table(diam.device)
        return table_lookup(table, x, n, k)
    if method == "mie_fit":
        return fit_lookup(x, n, k)
    q_ext, q_abs = adt_efficiencies(diam, n, k, wavelength)
    g = torch.clamp(0.85 * (1.0 - torch.exp(-x / 2.0)), 0.0, 0.9)
    return q_ext, q_ext - q_abs, g


def per_particle_optics(state: AeroState, aero_data: AeroData,
                        wavelengths=WAVELENGTHS, method="mie",
                        mie_table=None, maxwell_garnett: bool = False):
    """Per-particle scattering/absorption cross-sections [m2] and asymmetry
    per band: ([W, ..., P] c_sca, c_abs, g)."""
    diam = torch.clamp(state.wet_diameter(), min=1e-9)
    n, k = particle_refractive_index(state, aero_data, maxwell_garnett=maxwell_garnett)
    area = (torch.pi / 4.0) * diam * diam
    c_sca, c_abs, gs = [], [], []
    for wl in wavelengths:
        q_ext, q_sca, g = particle_efficiencies(diam, n, k, wl, method, mie_table)
        c_sca.append(q_sca * area)
        c_abs.append((q_ext - q_sca) * area)
        gs.append(g)
    return torch.stack(c_sca), torch.stack(c_abs), torch.stack(gs)


def mie_fit_sums_plain(diam, n, k, live_num, wavelengths=WAVELENGTHS):
    """K5's plain version: per band and cell, Σ c_sca·num, Σ c_abs·num and
    Σ c_sca·g·num over the slots (the last axis) by ``fit_lookup``, as
    ``per_particle_optics`` forms the cross-sections.  diam, n, k, live_num:
    [..., P]; returns [3, W, ...]."""
    area = (torch.pi / 4.0) * diam * diam
    bands = []
    for wl in wavelengths:
        q_ext, q_sca, g = fit_lookup(torch.pi * diam / wl, n, k)
        c_sca = q_sca * area
        bands.append(torch.stack([torch.sum(c_sca * live_num, dim=-1),
                                  torch.sum((q_ext - q_sca) * area * live_num, dim=-1),
                                  torch.sum(c_sca * g * live_num, dim=-1)]))
    return torch.stack(bands, dim=1)


def mie_fit_sums(diam, n, k, live_num, wavelengths=WAVELENGTHS):
    """``mie_fit_sums_plain``'s [3, W, ...] sums, on every device."""
    return mie_fit_sums_plain(diam, n, k, live_num, wavelengths)


def bulk_optical_props(state: AeroState, aero_data: AeroData, dz, cell_volume,
                       wavelengths=WAVELENGTHS, method="mie_fit", mie_table=None,
                       maxwell_garnett: bool = False) -> BulkOptics:
    """Per-particle cross-sections summed to layer tauaer/waer/gaer; dz:
    [nz] layer depths, cell_volume [nz, ny, nx].  ``"mie_fit"`` takes the
    sums from ``mie_fit_sums`` (K5 on the card)."""
    live_num = torch.where(state.alive, state.num, 0.0)
    if method == "mie_fit":
        diam = torch.clamp(state.wet_diameter(), min=1e-9)
        n, k = particle_refractive_index(state, aero_data, maxwell_garnett=maxwell_garnett)
        s_sca, s_abs, s_g = mie_fit_sums(diam, n, k, live_num, wavelengths)
    else:
        c_sca, c_abs, g_i = per_particle_optics(state, aero_data, wavelengths, method,
                                                mie_table, maxwell_garnett=maxwell_garnett)
        s_sca = torch.sum(c_sca * live_num, dim=-1)
        s_abs = torch.sum(c_abs * live_num, dim=-1)
        s_g = torch.sum(c_sca * g_i * live_num, dim=-1)
    b_sca = s_sca / cell_volume
    b_ext = b_sca + s_abs / cell_volume
    tau = b_ext * dz.reshape(1, -1, 1, 1)
    w0 = b_sca / torch.clamp(b_ext, min=1e-30)
    g = s_g / torch.clamp(s_sca, min=1e-30)
    return BulkOptics(tauaer=tau, waer=w0, gaer=g)


def scat_abs_coeffs(state: AeroState, aero_data: AeroData, cell_volume,
                    wavelength: float = 5.5e-7, method="mie", mie_table=None):
    """Bulk scattering/absorption coefficients [m-1] at one wavelength."""
    c_sca, c_abs, _ = per_particle_optics(state, aero_data, (wavelength,), method,
                                          mie_table)
    live_num = torch.where(state.alive, state.num, 0.0)
    return (torch.sum(c_sca[0] * live_num, dim=-1) / cell_volume,
            torch.sum(c_abs[0] * live_num, dim=-1) / cell_volume)
