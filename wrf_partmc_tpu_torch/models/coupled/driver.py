"""The coupled WRF-PartMC timestep.

Port of the single-device path of ``wrf_partmc_tpu/models/coupled/driver.py``
(``mesh=None``): partmc_to_wrf -> ARW dycore (with Morrison microphysics
for mp_physics=10) -> specified + relaxation lateral boundaries (with a
wrfbdy) -> MYJ surface layer and TKE PBL (bl_physics=2) -> implicit
vertical diffusion -> partmc_from_wrf -> emission -> aerosol optics
(do_optical) -> the chemistry macro-step every ``partmc_chem_dt``
(nucleation, coagulation, MOSAIC with the aerosol-attenuated photolysis,
condensation) -> Grell cumulus (cu_physics=5) -> radiation and the land
surface (ra_physics 1/4, sf_surface_physics 1/2) -> stochastic transport
-> open-boundary inflow resampling and gas BCs -> surface deposition ->
rebalance.  With ``record_removals`` the state carries the represented
number each number-decreasing process removed, per cell and cause; with
``record_aero_info`` a chemistry step also returns the coagulation removal
records (``coag_step(return_events=True)``).

:class:`CoupledModel` holds the static tables (grid metrics, ``AeroData``,
``GasData``, the CBM-Z ``Mechanism``, ``Scenario``, ``exch_h``, the wrfbdy
slabs and zone weights) as registered buffers, so ``.to(device)`` moves
them all; ``forward(state)`` returns the next :class:`CoupledState`.  The
step counter is a host int, so the reference's ``lax.cond`` on the
chemistry cadence is a Python ``if``.

Units at the coupling surface: chem tracers carry ppm, gas states ppb;
NUM_CONC class tracers carry number per kg of dry air, particle
populations absolute represented number per cell.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ... import constants as c
from ...config import Config
from ...grid import Grid
from ...ops.stencil import AXIS_X, AXIS_Y, shift
from ...ops.vdiff import vertical_diffusion_state
from ...utils import rng
from ...utils.tree import tensor_leaves, tree_map, with_leaves
from ..dycore.solve import solve_step
from ..dycore.state import DycoreState, base_profiles, temperature, total_pressure
from ..partmc.aero_data import AeroData, particle_mass, particle_volume
from ..partmc.aero_state import AeroState, rebalance, zero_state
from ..partmc.cbmz import Mechanism, build_mechanism, solar_cos_zenith
from ..partmc.coag import coag_step
from ..partmc.condense import condense_dynamic, equilib_water_hyst
from ..partmc.deposition import aerodynamic_resistance, deposition_velocity
from ..partmc.env_state import EnvState
from ..partmc.gas_data import GasData
from ..partmc.mosaic import mosaic_timestep
from ..partmc.nucleate import nucleate_step
from ..partmc.optics import bulk_optical_props
from ..partmc.scenario import Scenario, update_aero_state, update_gas_state
from ..partmc.simple_chem import chem_step
from ..physics.grell import grell_step
from ..physics.lsm import (LandState, NoahState, init_land, init_noah, noah_lsm_step,
                           slab_lsm_step)
from ..physics.myj import init_q2, myj_surface_layer, myj_tke_step
from ..physics.radiation import photolysis_aerosol_factor, radiation_driver
from ..physics.thermo import relative_humidity
from .bdy import BdyData, apply_specified_relax, zone_weights
from .boundary import apply_gas_open_bc, resample_inflow_particles
from .transport import transport_step


@dataclass(frozen=True)
class CoupledState:
    dyn: DycoreState
    aero: AeroState          # cell shape (nz, ny, nx)
    gas: torch.Tensor        # [nz, ny, nx, G] ppb
    step: int                # host step counter
    # land-surface state: LandState (sf_surface_physics=1), NoahState (=2)
    land: LandState | NoahState | None = None
    # MYJ twice-TKE at w levels [nz+1, ny, nx] (bl_physics=2)
    pbl_q2: torch.Tensor | None = None
    # cumulative represented number removed per cell [nz, ny, nx], by cause
    # (REMOVAL_CAUSES; record_removals), None when off
    removals: dict | None = None

    def to(self, device) -> "CoupledState":
        return tree_map(lambda t: t.to(device), self)


def cell_air_mass(dyn: DycoreState, grid: Grid):
    """[nz, ny, nx] dry-air mass per cell [kg]: m = mu_d deta dA / g."""
    mu_d = grid.mub + dyn.mu
    return (mu_d[None] * grid.deta.reshape(-1, 1, 1) / c.GRAV
            * (grid.dx * grid.dy))


def cell_volume_3d(dyn: DycoreState, grid: Grid):
    """[nz, ny, nx] actual grid-cell volume [m3] from the geopotential."""
    phi = grid.phb + dyn.ph
    dz = (phi[1:] - phi[:-1]) / c.GRAV
    return dz * (grid.dx * grid.dy)


def step_time(step: int, dt: float) -> float:
    """Model time of a step as the reference computes it (f32 step * dt)."""
    return float(np.float32(np.float32(step) * np.float32(dt)))


def make_env(dyn: DycoreState, grid: Grid, cfg: Config, step: int) -> EnvState:
    """Per-cell environment from the dycore state; u* is diagnosed from the
    first-level wind with the neutral log law."""
    temp = temperature(dyn, grid)
    pres = total_pressure(dyn, grid)
    rh = relative_humidity(dyn.moist[0], temp, pres)
    vol = cell_volume_3d(dyn, grid)
    u1 = 0.5 * (dyn.u[0] + shift(dyn.u[0], 1, AXIS_X))
    v1 = 0.5 * (dyn.v[0] + shift(dyn.v[0], 1, AXIS_Y))
    spd = torch.sqrt(u1 * u1 + v1 * v1)
    logz = torch.log(torch.clamp(grid.z_half[0] / cfg.dynamics.sfc_z0, min=1.1))
    us2d = c.KARMAN * torch.clamp(spd, min=0.1) / logz
    ustar = us2d.expand(temp.shape)
    phi = grid.phb + dyn.ph
    z = 0.5 * (phi[1:] + phi[:-1]) / c.GRAV
    return EnvState(temp=temp, pressure=pres, rel_humid=rh, height=z,
                    cell_volume=vol, ustar=ustar,
                    elapsed_time=step_time(step, cfg.dynamics.dt))


def partmc_to_wrf(cs: CoupledState, grid: Grid, cfg: Config) -> DycoreState:
    """Particle number per class and gases into the Eulerian tracers."""
    air_mass = cell_air_mass(cs.dyn, grid)
    nbc = cs.aero.num_by_class(cfg.n_class)                  # [nz,ny,nx,C]
    num_tr = nbc.movedim(-1, 0) / air_mass
    chem = cs.gas.movedim(-1, 0) / 1000.0                    # ppb -> ppm
    return dataclasses.replace(cs.dyn, num_conc=num_tr.contiguous(),
                               chem=chem.contiguous())


def partmc_from_wrf(dyn: DycoreState) -> torch.Tensor:
    """Advected gases back to the particle model, ppm -> ppb."""
    return dyn.chem.movedim(0, -1) * 1000.0


def emission_step(aero: AeroState, gas, env: EnvState, aero_data: AeroData,
                  scn: Scenario, cfg: Config, t, key):
    """Per-dt scenario forcing (emission on): gas emission/dilution and
    aerosol emission/dilution."""
    pc = cfg.partmc
    dt = cfg.dynamics.dt
    k_scn, _k_ss = rng.split(key)
    gas = update_gas_state(scn, gas, t, dt)
    aero = update_aero_state(scn, aero, aero_data, t, dt, k_scn,
                             pc.n_emit_slots, env.cell_volume)
    return aero, gas


def uses_cbmz(cfg: Config, gas_data: GasData) -> bool:
    """Whether MOSAIC runs the full CBM-Z mechanism (else the simple
    stand-in), as the reference decides it."""
    return (cfg.partmc.do_mosaic and cfg.partmc.chem_mech != "simple"
            and gas_data.n_spec >= 77)


def microphysics_step(aero: AeroState, gas, env: EnvState, aero_data: AeroData,
                      gas_data: GasData, cfg: Config, t: float, key,
                      mech: Mechanism | None = None, j_scale=None):
    """The chem-macro-step work, in the reference's order: nucleation,
    coagulation, MOSAIC (or the simple chemistry), condensation (equilibrium
    water with hysteresis, or the dynamic ODE).  ``mech`` is the CBM-Z
    mechanism when :func:`uses_cbmz`; ``j_scale`` the per-cell aerosol
    attenuation of photolysis.  Returns (aero, gas, coag_removed, events):
    the represented number coagulation removed per cell and, with
    ``record_aero_info``, its removal records (else ``{}``)."""
    pc = cfg.partmc
    dt_chem = pc.partmc_chem_dt
    k_coag, _k_scn, _k_ss = rng.split(key, 3)
    coag_removed = torch.zeros_like(env.temp)
    events = {}
    if pc.do_nucleation:
        aero, gas = nucleate_step(aero, gas, gas_data, aero_data, env.temp,
                                  env.pressure, env.cell_volume, dt_chem)
    if pc.do_coagulation:
        n0 = aero.total_num()
        if pc.record_aero_info:
            aero, events = coag_step(aero, aero_data, env, dt_chem, k_coag,
                                     return_events=True)
        else:
            aero = coag_step(aero, aero_data, env, dt_chem, k_coag)
        coag_removed = torch.clamp(n0 - aero.total_num(), min=0.0)
    if pc.do_mosaic:
        if uses_cbmz(cfg, gas_data):
            cosz = solar_cos_zenith(cfg.domain, t).to(gas.device)
            aero, gas = mosaic_timestep(mech, aero, gas, gas_data, aero_data, env,
                                        dt_chem, cosz, n_sub_gas=pc.n_sub_gas,
                                        n_sub_astem=pc.n_sub_astem, j_scale=j_scale)
        else:
            aero, gas = chem_step(aero, gas, gas_data, aero_data, env, dt_chem)
    if pc.do_condensation:
        if pc.condense_mode == "dynamic":
            aero, _s = condense_dynamic(aero, aero_data, env, dt_chem)
        else:
            aero = equilib_water_hyst(aero, aero_data, env)
    return aero, gas, coag_removed, events


def surface_deposition(aero: AeroState, env: EnvState, aero_data: AeroData,
                       grid: Grid, cfg: Config, key, rmol=None,
                       dz1=None) -> AeroState:
    """Dry deposition from the lowest model layer, stochastic per-particle
    removal.  ``rmol`` [ny, nx]: 1/Monin-Obukhov length from the surface
    layer (stability-corrected aerodynamic resistance; neutral without it).
    ``dz1`` [ny, nx]: the geopotential first-layer depth."""
    diam = torch.clamp(aero.wet_diameter(), min=1e-9)
    pvol = particle_volume(aero.vol)
    mass = particle_mass(aero.vol, aero_data)
    rho_p = mass / torch.clamp(pvol, min=0.0)                  # 1e-300 is 0 in f32
    r_a = aerodynamic_resistance(env, grid.z_half[0], z0=cfg.dynamics.sfc_z0,
                                 rmol=rmol)
    v_d = deposition_velocity(diam, rho_p, env, r_a)
    depth1 = grid.dz[0] if dz1 is None else dz1[None, :, :, None]
    p_rem = torch.clamp(v_d * cfg.dynamics.dt / depth1, 0.0, 1.0)
    k0 = torch.arange(aero.num.shape[0], device=p_rem.device).reshape(-1, 1, 1, 1) == 0
    p_rem = torch.where(k0, p_rem, 0.0)
    u = rng.uniform(key, aero.num.shape, aero.num.device)
    keep = (u >= p_rem) & aero.alive
    return dataclasses.replace(
        aero, num=torch.where(keep, aero.num, 0.0),
        vol=torch.where(keep[..., None, :], aero.vol, 0.0))


def check_supported(cfg: Config) -> None:
    """Refuse configurations whose code paths are not ported yet."""
    d, p = cfg.dynamics, cfg.partmc
    off = {
        "partmc.seasalt_param": p.seasalt_param,
        "dynamics.sfs_opt=1 (NBA subfilter stress)": d.sfs_opt == 1,
        "dynamics.km_opt=2 with diff_opt=2 (prognostic TKE)": d.km_opt == 2 and d.diff_opt == 2,
        "dynamics WENO advection orders": isinstance(d.h_adv_order, str)
                                          or isinstance(d.v_adv_order, str),
        "dynamics.bl_physics=1 (YSU)": d.bl_physics == 1,
        "dynamics.cu_physics=2 (BMJ)": d.cu_physics == 2,
        "dynamics.mp_physics=1/2 (Kessler/WSM5)": d.mp_physics in (1, 2),
        "dynamics.dyn_opt != 'arw'": d.dyn_opt != "arw",
    }
    bad = [name for name, on in off.items() if on]
    if bad:
        raise NotImplementedError("not ported yet: " + ", ".join(bad))


def _season(cfg: Config) -> str:
    """LANDUSE season column by hemisphere and julian day (NH summer is
    Apr 15 - Oct 15, reversed in the SH)."""
    nh_summer = 105 <= cfg.domain.julian_day <= 288
    return "summer" if (nh_summer if cfg.domain.lat0 >= 0 else not nh_summer) else "winter"


REMOVAL_CAUSES = ("dilution", "coag", "chem", "outflow", "deposition", "halving")
TRANSPORT_COUNTERS = ("overflow_class", "overflow_free", "movers")


def coupled_step(cs: CoupledState, grid: Grid, cfg: Config,
                 aero_data: AeroData, gas_data: GasData, scn: Scenario, exch_h,
                 base_seed_key, mech: Mechanism | None = None,
                 bdy: BdyData | None = None, bdy_w2=None):
    """One full coupled timestep.  ``bdy``: the wrfbdy time series of the
    specified + relaxation boundaries (``bdy_w2`` its zone weights).
    Returns (new_state, diag): the transport saturation counters
    (``TRANSPORT_COUNTERS``, 0-d tensors, zero with transport off) and, on
    a chemistry step with ``record_aero_info``, the coagulation removal
    records ``coag_removed_id`` / ``coag_other_id`` [nz, ny, nx, P//2]."""
    pc = cfg.partmc
    dy = cfg.dynamics
    dt = dy.dt
    m_chem = max(1, int(round(pc.partmc_chem_dt / dt)))
    rem = dict(cs.removals) if cs.removals is not None else None

    def record(cause, before, after):
        # number-decreasing processes: represented number removed per cell
        if rem is not None:
            rem[cause] = rem[cause] + torch.clamp(
                before.total_num() - after.total_num(), min=0.0)
    keys = {s: rng.step_key(base_seed_key, cs.step, s)
            for s in (rng.STREAM_COAG, rng.STREAM_EMISSION,
                      rng.STREAM_TRANSPORT, rng.STREAM_DEPOSITION,
                      rng.STREAM_REBALANCE)}
    t = step_time(cs.step, dt)
    cosz = solar_cos_zenith(cfg.domain, t)          # 0-d CPU tensor, a scalar operand

    dyn = partmc_to_wrf(cs, grid, cfg)
    dyn2, diag = solve_step(dyn, grid, cfg)
    if bdy is not None:
        dyn2 = apply_specified_relax(dyn2, bdy, t, grid, cfg, bdy_w2)
    aero = cs.aero

    # MYJ surface layer + TKE PBL: replace the prescribed exch_h and u*
    sfc_ustar = sfc_rmol = None
    q2_new = cs.pbl_q2
    if dy.bl_physics == 2:
        theta = grid.t_base.reshape(-1, 1, 1) + dyn2.theta_p
        u1 = 0.5 * (dyn2.u[0] + shift(dyn2.u[0], 1, AXIS_X))
        v1 = 0.5 * (dyn2.v[0] + shift(dyn2.v[0], 1, AXIS_Y))
        if cs.land is not None:
            thsfc = cs.land.tsk / (grid.pb3[0] / c.P0) ** c.KAPPA
        else:
            thsfc = theta[0] + dy.sfc_heat_excess * torch.clamp(cosz, min=-0.25)
        u3 = 0.5 * (dyn2.u + shift(dyn2.u, 1, AXIS_X))
        v3 = 0.5 * (dyn2.v + shift(dyn2.v, 1, AXIS_Y))
        sfc = myj_surface_layer(u1, v1, theta[0], thsfc, grid.z_half[0], z0=dy.sfc_z0)
        q2_new, exch_h, _exch_m = myj_tke_step(cs.pbl_q2, theta, u3, v3, grid,
                                               sfc["ustar"], dt)
        sfc_ustar, sfc_rmol = sfc["ustar"], sfc["rmol"]

    if dy.vert_diff_fields and not dy.constant_velocity:
        rho_b, _, _ = base_profiles(grid)
        kv = exch_h
        if dy.diff_opt == 1 and dy.kvdif > 0:
            kv = kv + dy.kvdif
        dyn2 = vertical_diffusion_state(dyn2, kv, grid, rho_b, dt)

    gas = partmc_from_wrf(dyn2)
    env = make_env(dyn2, grid, cfg, cs.step)
    if sfc_ustar is not None:
        env = dataclasses.replace(env, ustar=sfc_ustar.expand(env.temp.shape))

    if pc.do_emission:
        a0 = aero
        aero, gas = emission_step(aero, gas, env, aero_data, scn, cfg, t,
                                  keys[rng.STREAM_EMISSION])
        record("dilution", a0, aero)
    else:
        gas = update_gas_state(scn, gas, t, dt)

    # aerosol optics, for the radiation direct effect and the photolysis
    # attenuation; from the population before this step's chemistry
    radiation = dy.ra_physics in (1, 4)
    optics = None
    if pc.do_optical and radiation:
        optics = bulk_optical_props(aero, aero_data, grid.dz, env.cell_volume)

    tdiag = {}
    if ((pc.do_coagulation or pc.do_condensation or pc.do_nucleation
         or pc.do_mosaic) and cs.step % m_chem == 0):
        j_scale = None
        if optics is not None and pc.do_mosaic:
            j_scale = photolysis_aerosol_factor(optics.tauaer, optics.waer,
                                                optics.gaer, cosz)
        a0 = aero
        aero, gas, coag_rem, events = microphysics_step(
            aero, gas, env, aero_data, gas_data, cfg, t, keys[rng.STREAM_COAG],
            mech=mech, j_scale=j_scale)
        if rem is not None:
            # coagulation's losses apart from the rest of the macro-step's
            # (nucleation, MOSAIC, condensation)
            rem["coag"] = rem["coag"] + coag_rem
            rem["chem"] = rem["chem"] + torch.clamp(
                a0.total_num() - aero.total_num() - coag_rem, min=0.0)
        if events:
            tdiag["coag_removed_id"] = events["removed_id"]
            tdiag["coag_other_id"] = events["other_id"]

    if dy.cu_physics == 5:
        dyn2, _rainc = grell_step(dyn2, grid, dt)

    land2 = cs.land
    if radiation:
        rho_b, _, _ = base_profiles(grid)
        rho3 = rho_b.reshape(-1, 1, 1).expand(env.temp.shape)
        hr, rad = radiation_driver(
            temperature(dyn2, grid), dyn2.moist[0], rho3, grid.dz, cosz,
            t_sfc=(cs.land.tsk if cs.land is not None else None), optics=optics,
            lw_scheme="kdist" if dy.ra_physics == 4 else "gray",
            sw_scheme="kdist" if dy.ra_physics == 4 else "dudhia")
        dyn2 = dataclasses.replace(dyn2, theta_p=dyn2.theta_p + dt * hr)
        # the land surface takes this step's radiation and the surface
        # layer's u*
        if cs.land is not None and sfc_ustar is not None:
            exner_sfc = (grid.pb3[0] / c.P0) ** c.KAPPA
            th1 = grid.t_base[0] + dyn2.theta_p[0]
            lsm_args = (cs.land, rad["sw_sfc_down"], rad["lw_sfc_down"],
                        temperature(dyn2, grid)[0], dyn2.moist[0][0], rho3[0],
                        sfc_ustar, exner_sfc, th1, dt)
            if dy.sf_surface_physics == 2:
                land2, _fluxes = noah_lsm_step(*lsm_args, season=_season(cfg))
            else:
                land2, _fluxes = slab_lsm_step(*lsm_args)

    dz3 = None
    periodic = cfg.boundary.periodic_x and cfg.boundary.periodic_y
    if pc.do_transport:
        vol3 = cell_volume_3d(dyn2, grid)
        rho3 = cell_air_mass(dyn2, grid) / vol3
        dz3 = vol3 / (grid.dx * grid.dy)
        a0 = aero
        aero, trans = transport_step(aero, diag.probs, diag.xkhh, exch_h, grid,
                                     cfg, dt, keys[rng.STREAM_TRANSPORT],
                                     rho3=rho3, dz3=dz3)
        tdiag.update(trans)
        if not periodic:
            record("outflow", a0, aero)
    else:
        zero = torch.zeros((), dtype=torch.float32, device=aero.num.device)
        tdiag.update({k: zero for k in TRANSPORT_COUNTERS})

    if not periodic:
        bc_key = rng.step_key(base_seed_key, cs.step, rng.STREAM_BC)
        aero = resample_inflow_particles(aero, dyn2, scn, aero_data, grid, cfg, bc_key)
        gas = apply_gas_open_bc(gas, dyn2, scn, grid, cfg)
    if pc.do_deposition:
        a0 = aero
        aero = surface_deposition(aero, env, aero_data, grid, cfg,
                                  keys[rng.STREAM_DEPOSITION], rmol=sfc_rmol,
                                  dz1=dz3[0] if dz3 is not None else None)
        record("deposition", a0, aero)
    a0 = aero
    aero = rebalance(aero, keys[rng.STREAM_REBALANCE], pc.num_particles,
                     pc.allow_halving, pc.allow_doubling)
    record("halving", a0, aero)
    # every leaf contiguous (moist, chem and gas come out as transposed
    # views): a state read back from a restart is contiguous, and reductions
    # may sum in another order over another layout, so one layout keeps a
    # resumed run bit-equal to the run that wrote the restart
    out = CoupledState(dyn=dyn2, aero=aero, gas=gas, step=cs.step + 1,
                       land=land2, pbl_q2=q2_new, removals=rem)
    return tree_map(lambda t: t.contiguous(), out), tdiag


def init_coupled(cfg: Config, grid: Grid, aero_data: AeroData,
                 gas_data: GasData, dyn: DycoreState,
                 ivgtyp=None, isltyp=None) -> CoupledState:
    dev = grid.dz.device
    aero = zero_state(aero_data, cfg.partmc.max_particles,
                      cell_shape=(grid.nz, grid.ny, grid.nx), device=dev)
    gas = torch.zeros((grid.nz, grid.ny, grid.nx, gas_data.n_spec),
                      dtype=torch.float32, device=dev)
    t_sfc0 = float(grid.t_base[0])            # theta ~ T at the surface
    land = None
    if cfg.dynamics.sf_surface_physics == 1:
        land = init_land(grid.ny, grid.nx, t_sfc0, device=dev)
    elif cfg.dynamics.sf_surface_physics == 2:
        land = init_noah(grid.ny, grid.nx, t_sfc0, tbot=t_sfc0 - 3.0,
                         ivgtyp=ivgtyp, isltyp=isltyp, device=dev)
    pbl_q2 = init_q2(grid) if cfg.dynamics.bl_physics == 2 else None
    removals = None
    if cfg.partmc.record_removals:
        z3 = torch.zeros((grid.nz, grid.ny, grid.nx), dtype=torch.float32, device=dev)
        removals = {k: z3 for k in REMOVAL_CAUSES}
    return CoupledState(dyn=dyn, aero=aero, gas=gas, step=0, land=land,
                        pbl_q2=pbl_q2, removals=removals)


class CoupledModel(torch.nn.Module):
    """The coupled step as a module.  Static tables are registered buffers
    (non-persistent): grid metrics, ``AeroData``, ``GasData``, ``Scenario``,
    ``exch_h``, when MOSAIC runs CBM-Z the ``Mechanism`` tables, and with a
    wrfbdy (``bdy``) its slabs and the zone weights.  ``forward(state)``
    returns the next state; the step's diag (transport counters, removal
    records) is kept in ``last_diag``."""

    def __init__(self, cfg: Config, grid: Grid, aero_data: AeroData,
                 gas_data: GasData, scn: Scenario, exch_h, seed: int = 0,
                 bdy: BdyData | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.base_key = rng.base_key(seed)
        self._templates = {}
        tables = [("grid", grid), ("aero_data", aero_data), ("gas_data", gas_data),
                  ("scn", scn)]
        if uses_cbmz(cfg, gas_data):
            tables.append(("mech", build_mechanism(device=gas_data.molec_weight.device)))
        if bdy is not None:
            tables.append(("bdy", bdy))
            self.register_buffer("bdy_w2", zone_weights(grid, cfg), persistent=False)
        for name, obj in tables:
            self._templates[name] = obj
            for buf, t in tensor_leaves(obj, name).items():
                self.register_buffer(buf, t, persistent=False)
        self.register_buffer("exch_h", exch_h, persistent=False)
        self.last_diag = {}

    def _table(self, name: str):
        return with_leaves(self._templates[name], name, dict(self.named_buffers()))

    @property
    def grid(self) -> Grid:
        return self._table("grid")

    @property
    def aero_data(self) -> AeroData:
        return self._table("aero_data")

    @property
    def gas_data(self) -> GasData:
        return self._table("gas_data")

    @property
    def scn(self) -> Scenario:
        return self._table("scn")

    @property
    def mech(self) -> Mechanism | None:
        return self._table("mech") if "mech" in self._templates else None

    @property
    def bdy(self) -> BdyData | None:
        return self._table("bdy") if "bdy" in self._templates else None

    def forward(self, state: CoupledState) -> CoupledState:
        bdy = self.bdy
        out, self.last_diag = coupled_step(
            state, self.grid, self.cfg, self.aero_data, self.gas_data, self.scn,
            self.exch_h, self.base_key, mech=self.mech, bdy=bdy,
            bdy_w2=self.bdy_w2 if bdy is not None else None)
        return out
