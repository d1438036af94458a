"""Coupled-model initialization: the population builders and the
file-driven branches.

Port of ``wrf_partmc_tpu/models/coupled/init.py``: the idealized
populations (``populate_from_number_field``, ``populate_from_dist``), the
file-driven init of ``init_wrf_partmc`` (``init_from_files``: per-level IC
modes, emission series and lateral-BC backgrounds from the
``tools/make_inputs.py`` contract) and the PartMC ``.spec`` scenario
(``init_from_spec``).  Each file branch returns a ``scenario_fn(t)`` that
gives the :class:`Scenario` for model time t.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import constants as c
from ...config import Config
from ...grid import Grid
from ...utils.tree import tree_map
from ..partmc.aero_data import AeroData, diam_to_vol
from ..partmc.aero_state import AeroState, add_particles, fill_fresh, zero_state
from ..partmc.dist import AeroDist, sample_particles
from ..partmc.scenario import Scenario, at_clamped


def populate_from_number_field(aero_data: AeroData, cfg: Config, grid: Grid,
                               number_conc, key=None, n_per_cell: int | None = None,
                               diam: float = 1e-7, spec: str = "SO4",
                               w_class: int = 0, source: int = 0) -> AeroState:
    """Monodisperse population whose per-cell represented number matches the
    Eulerian field ``number_conc`` [nz, ny, nx] [# m-3], so particles and
    the NUM_CONC tracer start identical.  ``key`` is unused (the population
    is deterministic); it is kept for the reference's signature.  A cell
    where the field is 0 gets dead slots."""
    if n_per_cell is None:
        n_per_cell = cfg.partmc.num_particles
    cell_shape = (grid.nz, grid.ny, grid.nx)
    dev = grid.dz.device
    st = zero_state(aero_data, cfg.partmc.max_particles, cell_shape, device=dev)
    total = number_conc * grid.cell_volume.reshape(-1, 1, 1)
    E = n_per_cell
    num = (total / E)[..., None].expand(*cell_shape, E).to(torch.float32)
    pvol = diam_to_vol(torch.tensor(diam, dtype=torch.float32, device=dev))
    vol = torch.zeros((*cell_shape, aero_data.n_spec, E), dtype=torch.float32, device=dev)
    vol[..., aero_data.spec_by_name(spec), :] = torch.where(num > 0, pvol, 0.0)
    src = torch.full((*cell_shape, E), source, dtype=torch.int32, device=dev)
    wcl = torch.full((*cell_shape, E), w_class, dtype=torch.int32, device=dev)
    return add_particles(st, vol, num, src, wcl)


def populate_from_dist(aero_data: AeroData, cfg: Config, grid: Grid,
                       dist: AeroDist, key, n_per_cell: int | None = None,
                       block=None) -> AeroState:
    """Sample the mode set into every cell; the E sampled entries fill slots
    0..E-1 directly (``fill_fresh``, no placement kernel).  With ``block``
    (``rng.Block``), only a rank's block of cells, with the block's slice of
    the global draws."""
    if n_per_cell is None:
        n_per_cell = cfg.partmc.num_particles
    cell_shape = ((grid.nz, grid.ny, grid.nx) if block is None
                  else (grid.nz, block.ny_l, block.nx_l))
    V = grid.cell_volume.reshape(-1, 1, 1).expand(cell_shape)
    vol, num, src, wcl = sample_particles(key, dist, aero_data, n_per_cell,
                                          V, cell_shape, block)
    return fill_fresh(aero_data, cfg.partmc.max_particles, vol, num, src, wcl)


def _cellify(a, trail: int):
    """Insert (ny, nx) broadcast axes when ``a`` carries a leading per-level
    z axis (``trail`` = the number of non-cell trailing axes)."""
    if a.dim() == trail + 1:          # [nz, ...] -> [nz, 1, 1, ...]
        return a.reshape(a.shape[0], 1, 1, *a.shape[1:])
    return a


def _cellify_dist(d: AeroDist) -> AeroDist:
    return dataclasses.replace(
        d, num_conc=_cellify(d.num_conc, 1), geom_mean_diam=_cellify(d.geom_mean_diam, 1),
        log_geom_std=_cellify(d.log_geom_std, 1), vol_frac=_cellify(d.vol_frac, 2))


def _empty_emission(n_spec: int, T: int, device) -> AeroDist:
    """A one-mode emission series with no number (uniform composition)."""
    f = lambda v: torch.full((T, 1), v, dtype=torch.float32, device=device)
    z = lambda: torch.zeros(1, dtype=torch.int32, device=device)
    return AeroDist(num_conc=f(0.0), geom_mean_diam=f(1e-7), log_geom_std=f(0.5),
                    vol_frac=torch.full((T, 1, n_spec), 1.0 / n_spec, dtype=torch.float32,
                                        device=device),
                    source=z(), w_class=z())


def init_from_files(aero_data: AeroData, n_gas: int, cfg: Config, grid: Grid,
                    key, ics_path: str, emissions_path: str | None = None,
                    bcs_path: str | None = None):
    """The file-driven branch of ``init_wrf_partmc``
    (``wrf_pmc_init.F90:284-379``): per-level/per-cell IC modes sampled into
    every cell (``init_read_in_ics``), the emission mode series
    (``init_read_in_emissions``) and the lateral-BC background reservoir
    series (``init_read_in_bcs``, the scenario's background and dilution),
    read from the whole-domain NetCDF contract of ``tools/make_inputs.py``.

    Returns ``(aero_state, scenario_fn)``: ``scenario_fn(t)`` gives the
    :class:`Scenario` for model time t, with the emission series whole
    (interpolated per step) and the BC background of the time slab that
    holds t, chosen on the host as the reference's BC time-index trigger
    does (``wrf_pmc_trans_aero.F90:824-838``)."""
    from ...tools.make_inputs import read_bcs, read_emissions, read_ics

    dev = grid.dz.device
    ic_dist = _cellify_dist(read_ics(ics_path, device=dev))
    aero = populate_from_dist(aero_data, cfg, grid, ic_dist, key)

    if emissions_path is not None:
        emit_times, emit_dist, gas_rate = read_emissions(emissions_path, device=dev)
    else:
        emit_times = torch.zeros(1, dtype=torch.float32, device=dev)
        emit_dist = _empty_emission(aero_data.n_spec, 1, dev)
        gas_rate = torch.zeros((1, n_gas), dtype=torch.float32, device=dev)

    if bcs_path is not None:
        bc_times, bc_dist, bc_gas, bc_dil = read_bcs(bcs_path, device=dev)
        bc_times = bc_times.cpu().numpy()
    else:
        bc_times = np.zeros(1)
        bc_dist = tree_map(lambda a: a[:1] * 0, emit_dist)
        bc_gas = torch.zeros((1, n_gas), dtype=torch.float32, device=dev)
        bc_dil = torch.zeros(1, dtype=torch.float32, device=dev)

    slabs = {}        # one Scenario per BC time slab, built on first use

    def scenario_fn(t: float) -> Scenario:
        i = int(np.clip(np.searchsorted(bc_times, t, side="right") - 1,
                        0, len(bc_times) - 1))
        if i not in slabs:
            slabs[i] = Scenario(
                emit_times=emit_times, emit_dist=emit_dist, gas_emit_rate=gas_rate,
                dilution_rate=bc_dil[i],
                back_dist=_cellify_dist(tree_map(lambda a: at_clamped(a, i), bc_dist)),
                back_gas=_cellify(bc_gas[i], 1))
        return slabs[i]

    return aero, scenario_fn


def init_from_spec(aero_data: AeroData, gas_data, cfg: Config, grid: Grid,
                   key, spec_path: str):
    """A PartMC ``.spec`` scenario -> (population, gas [nz, ny, nx, G] ppb,
    scenario_fn): the spec-file branch of ``init_wrf_partmc`` (the per-height
    scenario of ``WRFV3/test/em_scm_xy/test.spec``).  Per-height IC modes and
    gas profiles map to model levels by height slab; the surface slab's
    emission series become the :class:`Scenario`, its fluxes divided by the
    lowest layer's depth and put in that layer only (the reference's 1/dz
    surface-emission coupling)."""
    from ...utils import spec_file as sf

    dev = grid.dz.device
    s = sf.load_scenario_spec(spec_path)
    z_spec = np.asarray(s["z"])
    z_half = grid.z_half.cpu().numpy()
    # height-slab index per model level (slab k covers [z_k, z_{k+1}))
    lev = np.clip(np.searchsorted(z_spec, z_half, side="right") - 1, 0, len(z_spec) - 1)

    # per-level ICs: the slabs' dists stacked on a leading z axis
    ic_by_slab = [sf.read_aero_dist_dat(p, aero_data) for p in s["aero_init"]]
    n_mode = ic_by_slab[0].n_mode
    if any(d.n_mode != n_mode for d in ic_by_slab):
        raise ValueError("aero_init files must agree on mode count")
    stack = lambda f: torch.stack([getattr(ic_by_slab[i], f) for i in lev])
    nz = grid.nz
    ic_dist = AeroDist(
        num_conc=stack("num_conc").reshape(nz, 1, 1, n_mode),
        geom_mean_diam=stack("geom_mean_diam").reshape(nz, 1, 1, n_mode),
        log_geom_std=stack("log_geom_std").reshape(nz, 1, 1, n_mode),
        vol_frac=stack("vol_frac").reshape(nz, 1, 1, n_mode, -1),
        source=ic_by_slab[0].source, w_class=ic_by_slab[0].w_class)
    aero = populate_from_dist(aero_data, cfg, grid, ic_dist, key)

    # per-level gas init [nz, ny, nx, G] ppb
    G = gas_data.n_spec
    gas_prof = np.stack([sf.read_gas_init_dat(p, gas_data) for p in s["gas_init"]])
    gas0 = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        gas_prof[lev][:, None, None, :], (nz, grid.ny, grid.nx, G)), np.float32), device=dev)

    # emissions: the surface slab's series, in the surface layer only
    dz0 = float(grid.dz[0])
    rho0 = float(c.P0 / (c.R_D * c.T0))       # surface base density, approx.
    n_air = rho0 / 0.028964                   # mol air m-3
    zmask = np.zeros((nz, 1, 1, 1), np.float32)
    zmask[0] = 1.0
    if s["gas_emission"] is not None:
        gt, gr, gemit = sf.read_gas_emit_dat(s["gas_emission"][0], gas_data)
        # mol m-2 s-1 -> ppb s-1 [T, nz, 1, 1, G]
        gas_rate = (gemit * gr[:, None] / (dz0 * n_air) * 1e9)[
            :, None, None, None, :] * zmask[None]
        emit_times = gt
    else:
        emit_times = np.zeros(1)
        gas_rate = np.zeros((1, nz, 1, 1, G))
    zm = torch.as_tensor(zmask, device=dev)
    if s["aero_emission"] is not None:
        at, ar, adists = sf.read_aero_emit_dat(s["aero_emission"][0], aero_data)
        if not np.array_equal(at, emit_times):
            # resample the aerosol series onto the gas time grid (slab lookup)
            idx = np.clip(np.searchsorted(at, emit_times, side="right") - 1, 0, len(at) - 1)
            adists = [adists[i] for i in idx]
            ar = ar[idx]
        # a dist's num_conc is a surface flux [# m-2 s-1]; / dz0 -> [# m-3 s-1]
        nc = torch.stack([d.num_conc * float(r) / dz0 for d, r in zip(adists, ar)])
        per_t = lambda f: torch.stack([getattr(d, f) for d in adists])[:, None, None, None]
        emit_dist = AeroDist(
            num_conc=nc[:, None, None, None, :] * zm[None],
            geom_mean_diam=per_t("geom_mean_diam") + 0 * zm[None],
            log_geom_std=per_t("log_geom_std") + 0 * zm[None],
            vol_frac=per_t("vol_frac") + 0 * zm[None, ..., None],
            source=adists[0].source, w_class=adists[0].w_class)
    else:
        emit_dist = _empty_emission(aero_data.n_spec, len(emit_times), dev)

    scn = Scenario(
        emit_times=torch.as_tensor(np.asarray(emit_times, np.float32), device=dev),
        emit_dist=emit_dist,
        gas_emit_rate=torch.as_tensor(np.asarray(gas_rate, np.float32), device=dev),
        dilution_rate=torch.zeros((), dtype=torch.float32, device=dev),
        back_dist=tree_map(lambda a: torch.zeros_like(a[0]), emit_dist),
        back_gas=torch.zeros(G, dtype=torch.float32, device=dev))
    return aero, gas0, lambda t: scn
