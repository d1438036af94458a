"""Configuration of the port: one frozen dataclass tree.

The port's own copy of ``wrf_partmc_tpu/config.py``: the same groups, field
names, defaults, cross-option checks (``validate_config``) and namelist
shim (``namelist_to_config``), so a WRF-PartMC user maps a
``namelist.input`` onto either package the same way.  Field names mirror
the reference namelist options (the Registry's ``rconfig`` entries,
``WRFV3/frame/module_configure.F``, ``Registry/registry.partmc:1-38``).
The tree is frozen and hashable, so it can key caches.
``convert.config_from_reference`` rebuilds it from a JAX-package
``Config``; ``tests/test_torch_config.py`` holds the two copies equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class DomainConfig:
    """&domains equivalent (``test/em_uniform/namelist.input:33-48``)."""

    nx: int = 40            # e_we - 1 (mass points in x)
    ny: int = 40            # e_sn - 1
    nz: int = 10            # e_vert - 1 (full eta levels - 1)
    dx: float = 2000.0      # [m]
    dy: float = 2000.0      # [m]
    ztop: float = 10000.0   # model top height [m] (ideal cases)
    p_top: float = 10000.0  # pressure at model top [Pa] (real-style base state)
    lat0: float = 40.0      # domain-center latitude [deg] (photolysis zenith)
    lon0: float = -88.0     # domain-center longitude [deg]
    julian_day: int = 172   # start day-of-year (&time_control julday)
    gmt: float = 12.0       # start hour UTC (&time_control gmt)


@dataclass(frozen=True)
class DynamicsConfig:
    """&dynamics equivalent (``namelist.input:72-97``)."""

    dt: float = 10.0              # model timestep [s]
    dyn_opt: str = "arw"          # "arw": full mass-coordinate nonhydrostatic
                                  # core (prognostic mu/phi, terrain,
                                  # models/dycore/arw.py); "linear": round-1
                                  # flat-terrain quasi-compressible p' core
    rk_order: int = 3             # Runge-Kutta order (solve_em.F:510)
    n_sound: int = 4              # acoustic substeps per RK3 full step
    h_adv_order: int = 5          # horizontal advection order
    v_adv_order: int = 3          # vertical advection order
    chem_adv_opt: str = "mono"    # "pd" (chem_adv_opt=1) | "mono" (=2, the
                                  # PartMC test namelists' choice,
                                  # test/em_uniform/namelist.input:93)
    moist_adv_opt: str = "pd"     # moist_adv_opt=1 (WRF default)
    khdif: float = 0.0            # constant horizontal diffusion [m2 s-1]
    kvdif: float = 0.0            # constant vertical diffusion [m2 s-1]
    smag_cs: float = 0.25         # Smagorinsky constant (diff_opt=2)
    diff_opt: int = 0             # 0=none, 1=constant K, 2=turbulence closure
    km_opt: int = 4               # with diff_opt=2: 2 = prognostic 1.5-order
                                  # TKE closure, 4 = 2-D Smagorinsky
                                  # (module_diffusion_em km_opt values)
    tke_seed: float = 0.01        # initial/floor subgrid TKE [m2 s-2]
    damp_opt: int = 0             # upper-level damping (0=off)
    zdamp: float = 5000.0         # damping-layer depth [m]
    dampcoef: float = 0.2
    epssm: float = 0.1            # acoustic-step forward-in-time weighting
    smdiv: float = 0.1            # divergence damping coefficient
    constant_velocity: bool = False  # PMC_CONSTANT_VEL: freeze dynamics
                                     # (solve_em.F:535,1326,1548)
    sfs_opt: int = 0                 # 0=off, 1=NBA1 nonlinear LES subfilter
                                     # stress (module_sfs_nba.F / Kosovic
                                     # 1997; the em_les closure)
    cu_physics: int = 0              # 0=off, 2=Betts-Miller-Janjic-class
                                     # convective adjustment, 5=Grell-class
                                     # ensemble mass-flux (module_cu_g3.F;
                                     # the CARES d01 choice) (cumulus_driver
                                     # slot, first_rk_step_part1.F:1052)
    mp_physics: int = 0              # 0=off, 1=Kessler warm rain, 2=WSM5-class
                                     # ice, 10=Morrison-class two-moment
    ra_physics: int = 0              # 0=off, 1=Dudhia-class SW + gray LW,
                                     # 4=RRTMG-class correlated-k LW + SW
                                     # (radiation_driver equivalent; aerosol
                                     # direct effect when partmc.do_optical)
    bl_physics: int = 0              # 0=prescribed exch_h argument,
                                     # 1=MO surface layer + YSU-class K
                                     # diagnosed from the flow every step
                                     # (sfclay + bl_ysu equivalents),
                                     # 2=MYJ surface layer + Mellor-Yamada
                                     # level-2.5 prognostic-TKE PBL
                                     # (module_sf_myjsfc + module_bl_myjpbl;
                                     # the CARES d01 pair)
    sfc_z0: float = 0.1              # roughness length [m] (znt)
    sfc_heat_excess: float = 1.0     # idealized daytime skin-theta excess [K]
    sf_surface_physics: int = 0      # 0=prescribed excess (scaled by cos
                                     # zenith), 1=slab LSM (force-restore),
                                     # 2=Noah-class 4-layer soil T/moisture
                                     # with vegetation resistance
                                     # (module_sf_noahdrv.F; CARES d02)
    vert_diff_fields: bool = True    # implicit vertical diffusion of
                                     # u/v/theta/moist/chem/tke from exch_h
                                     # (module_diffusion_em vertical path via
                                     # first_rk_step_part1.F:840); particles
                                     # always mix via the transport operator


@dataclass(frozen=True)
class BoundaryConfig:
    """&bdy_control equivalent."""

    periodic_x: bool = True
    periodic_y: bool = True
    open_xs: bool = False
    open_xe: bool = False
    open_ys: bool = False
    open_ye: bool = False
    spec_zone: int = 1
    relax_zone: int = 4


@dataclass(frozen=True)
class PartmcConfig:
    """&partmc namelist group (``Registry/registry.partmc:1-38``)."""

    num_particles: int = 128       # per-cell ideal computational particle count
    max_particles: int = 192       # static per-cell capacity (a fixed shape;
                                   # replaces reference doubling/halving alloc)
    n_emit_slots: int = 8          # static per-cell emission insertions per step
    partmc_chem_dt: float = 60.0   # microphysics macro-step [s] (registry.partmc:24)
    do_coagulation: bool = True
    do_emission: bool = True
    do_mosaic: bool = False        # gas/aerosol chemistry (do_mosaic,
                                   # registry.partmc; off in all in-tree
                                   # reference ideal cases)
    chem_mech: str = "cbmz"        # "cbmz": full 77-species CBM-Z + ASTEM/
                                   # MESA-lite + SOA (models/partmc/cbmz.py,
                                   # mosaic.py); "simple": reduced SO2->H2SO4
                                   # condensation stand-in (simple_chem.py)
    n_sub_gas: int = 6             # ROS2 substeps per chem macro-step
    n_sub_astem: int = 4           # ASTEM substeps per chem macro-step
    do_optical: bool = False
    do_deposition: bool = True
    do_transport: bool = True
    do_gridded_output: bool = True
    record_removals: bool = False  # accumulate per-cell represented-number
                                   # removal counters by cause (the
                                   # aero_info/record_removals bookkeeping,
                                   # registry.partmc, wrf_pmc_driver.F90:251)
    do_advanced_process: bool = True  # optical + internally-mixed
                                      # counterfactual diagnostics
                                      # (registry.partmc:23 equivalent)
    record_aero_info: bool = False    # per-particle coagulation removal
                                      # records (id, action=coag, other_id) —
                                      # the aero_info_array equivalent,
                                      # wrf_pmc_driver.F90:251; off by
                                      # default (adds [cells, P/2] int
                                      # outputs per chem step)
    do_condensation: bool = False  # water uptake each chem step
    condense_mode: str = "equilib" # "equilib" (condense_equilib_particles,
                                   # the coupled-model default,
                                   # wrf_pmc_driver.F90:1201) | "dynamic"
                                   # (full per-particle growth ODE,
                                   # PartMC condense.F90 equivalent)
    do_nucleation: bool = False    # H2SO4 nucleation (present-but-disabled in
                                   # the reference, wrf_pmc_driver.F90:175)
    allow_doubling: bool = True    # realized as weight-halving rebalance
    allow_halving: bool = True
    random_seed: int = 0
    n_coag_pairs: int = 64         # candidate coagulation pairs per cell per step
    weight_rescale_trigger: float = 2.0  # preweight rescale when projected
                                         # count > trigger * ideal
                                         # (wrf_pmc_trans_aero.F90:1374-1402)
    trans_cap_v: int = 0           # per-(cell, dest-level) mover cap in the
                                   # MXU rebucket (0 -> max(16, P//16); set
                                   # ~2P/nz explicitly for fully-convective
                                   # regimes); overflow is counted
                                   # (trans_diag/history trans_overflow_*)
                                   # and conserved by shipped-survivor rescale
    trans_cap_h: int = 0           # per-(cell, face) horizontal mover cap
                                   # (0 -> max(16, P // 16))
    seasalt_source: int = 0        # source id / weight classes discovered by
    seasalt_class_film: int = 1    # sources.build_universe (reference
    seasalt_class_spume: int = -1  # hardcodes 2 dedicated classes,
                                   # wrf_pmc_init.F90:1291-1431); spume < 0
                                   # -> single-class fallback
    w_prob_cap: float = 0.95       # vertical-face move-probability cap
                                   # (wrf_pmc_trans.F90:236-284)
    num_bins: int = 100            # diagnostic bin grid (registry.partmc_process:1)
    bin_d_min: float = 1e-9        # [m] bin_grid_make(...,1d-9,1d-3) diameter span
    bin_d_max: float = 1e-3
    seasalt_param: int = 0         # 0=off, 1=Gong-2003, 2=Ovadnevaite
    n_ccn_supersats: int = 4       # CCN activation spectra count (driver :1043-1100)


@dataclass(frozen=True)
class TimeControlConfig:
    """&time_control equivalent."""

    run_seconds: float = 3600.0
    history_interval_s: float = 600.0
    auxhist2_interval_s: float = 600.0   # aerosol diagnostic cadence
    restart_interval_s: float = 3600.0
    restart: bool = False


@dataclass(frozen=True)
class Config:
    domain: DomainConfig = field(default_factory=DomainConfig)
    dynamics: DynamicsConfig = field(default_factory=DynamicsConfig)
    boundary: BoundaryConfig = field(default_factory=BoundaryConfig)
    partmc: PartmcConfig = field(default_factory=PartmcConfig)
    time_control: TimeControlConfig = field(default_factory=TimeControlConfig)
    n_moist: int = 3        # qv, qc, qr
    n_moist_mass: int = 0   # leading moist entries that are MASS mixing
                            # ratios (enter q_tot buoyancy/EOS); 0 -> all.
                            # Morrison (mp=10) appends number moments
                            # nr/ni/ns which advect with the family but
                            # carry no mass
    n_chem_gas: int = 32    # transported gas species — must match the GasData
                            # table (77 in full CBM-Z/MOSAIC runs)
    n_class: int = 4        # aerosol weight classes (=NUM_CONC_a## tracer count,
                            # up to 40 in the reference registry.partmc_trans)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _replace_sub(cfg: Config, group: str, **kw) -> Config:
    return dataclasses.replace(cfg, **{group: dataclasses.replace(getattr(cfg, group), **kw)})


def validate_config(cfg: Config) -> Config:
    """Cross-option validation at startup — the ``module_check_a_mundo``
    equivalent (``share/module_check_a_mundo.F``).  Raises ValueError with
    every problem found; returns cfg unchanged when clean."""
    errs = []
    d, dy, b, p = cfg.domain, cfg.dynamics, cfg.boundary, cfg.partmc
    if d.nx < 3 or d.ny < 3 or d.nz < 2:
        errs.append(f"domain too small: {d.nx}x{d.ny}x{d.nz}")
    if dy.dt <= 0:
        errs.append("dynamics.dt must be positive")
    # acoustic CFL (check_a_mundo's dt-vs-dx guidance, made exact for the
    # split-explicit substeps: c_s * dtau / dx must stay < 1)
    if dy.dt > 0 and dy.n_sound > 0:
        cfl_s = 350.0 * (dy.dt / dy.n_sound) / min(d.dx, d.dy)
        if cfl_s >= 1.0:
            errs.append(
                f"acoustic substep CFL {cfl_s:.2f} >= 1 "
                f"(dt={dy.dt}, n_sound={dy.n_sound}, dx={d.dx}): "
                "reduce dt or raise n_sound")
    if dy.sf_surface_physics in (1, 2) and not (dy.bl_physics in (1, 2)
                                                and dy.ra_physics in (1, 4)):
        errs.append("sf_surface_physics=1/2 (slab/Noah LSM) requires "
                    "bl_physics in (1, 2) and ra_physics in (1, 4) — "
                    "otherwise the skin temperature is never integrated "
                    "(silent no-op)")
    if dy.sf_surface_physics not in (0, 1, 2):
        errs.append(f"sf_surface_physics {dy.sf_surface_physics} not in "
                    "0 (prescribed), 1 (slab), 2 (Noah-class 4-layer)")
    if dy.bl_physics not in (0, 1, 2):
        errs.append(f"bl_physics {dy.bl_physics} not in 0 (prescribed), "
                    "1 (YSU pair), 2 (MYJ pair)")
    if dy.cu_physics not in (0, 2, 5):
        errs.append(f"cu_physics {dy.cu_physics} not in 0 (off), 2 (BMJ), "
                    "5 (Grell ensemble)")
    if dy.mp_physics == 1 and cfg.n_moist < 3:
        errs.append("mp_physics=1 (Kessler) needs n_moist >= 3")
    if dy.mp_physics == 2 and cfg.n_moist < 5:
        errs.append("mp_physics=2 (WSM5-class) needs n_moist >= 5 (qv qc qr qi qs)")
    if dy.mp_physics == 10 and (cfg.n_moist, cfg.n_moist_mass) not in (
            (8, 5), (10, 6)):
        errs.append("mp_physics=10 (Morrison two-moment) needs "
                    "(n_moist, n_moist_mass) = (8, 5) [qv qc qr qi qs | "
                    "nr ni ns] or (10, 6) with graupel [qv qc qr qi qs qg | "
                    "nr ni ns ng] — number moments carry no mass")
    if (dy.h_adv_order not in (1, 2, 3, 4, 5, 6, "weno5", "weno3")
            or dy.v_adv_order not in (1, 2, 3, "weno3", "weno5")):
        errs.append(f"unsupported advection orders h={dy.h_adv_order} v={dy.v_adv_order}")
    if dy.chem_adv_opt not in ("pd", "mono") or dy.moist_adv_opt not in ("pd", "mono"):
        errs.append("chem/moist_adv_opt must be 'pd' or 'mono'")
    if dy.km_opt not in (2, 4):
        errs.append(f"km_opt {dy.km_opt} not supported (2=TKE 1.5, 4=Smagorinsky)")
    if not dy.constant_velocity and dy.n_sound < 1:
        errs.append("live dynamics needs n_sound >= 1")
    if dy.damp_opt and not (0.0 < dy.zdamp <= d.ztop):
        errs.append(f"zdamp {dy.zdamp} outside (0, ztop={d.ztop}]")
    # CFL guards (uniform-case scale: assume |u| <= ~50 m/s)
    if dy.dt * 50.0 > min(d.dx, d.dy):
        errs.append(f"dt={dy.dt} likely violates horizontal CFL at dx={d.dx}")
    if p.max_particles < p.num_particles:
        errs.append(f"max_particles {p.max_particles} < num_particles {p.num_particles}")
    if p.n_emit_slots > p.max_particles:
        errs.append("n_emit_slots exceeds particle capacity")
    if p.partmc_chem_dt < dy.dt:
        errs.append(f"partmc_chem_dt {p.partmc_chem_dt} < dt {dy.dt}")
    elif abs(p.partmc_chem_dt / dy.dt - round(p.partmc_chem_dt / dy.dt)) > 1e-6:
        errs.append("partmc_chem_dt must be an integer multiple of dt "
                    "(chem-step cadence, wrf_pmc_driver.F90:183)")
    if p.chem_mech not in ("cbmz", "simple"):
        errs.append(f"unknown chem_mech {p.chem_mech!r}")
    if p.condense_mode not in ("equilib", "dynamic"):
        errs.append(f"unknown condense_mode {p.condense_mode!r}")
    if p.do_mosaic and p.chem_mech == "cbmz" and cfg.n_chem_gas < 77:
        errs.append("do_mosaic with chem_mech='cbmz' needs the 77-species "
                    "gas registry (n_chem_gas=77, make_gas_data_cbmz)")
    if p.do_optical and not (dy.ra_physics or p.do_gridded_output):
        errs.append("do_optical has no consumer (enable ra_physics or "
                    "gridded output)")
    if p.seasalt_param not in (0, 1, 2):
        errs.append(f"seasalt_param {p.seasalt_param} not in 0/1/2")
    if p.num_bins < 2 or p.bin_d_min >= p.bin_d_max:
        errs.append("bad diagnostic bin grid")
    if (b.open_xs or b.open_xe) and b.periodic_x:
        errs.append("x boundary both periodic and open")
    if (b.open_ys or b.open_ye) and b.periodic_y:
        errs.append("y boundary both periodic and open")
    if cfg.n_class < 1 or cfg.n_class > 40:
        errs.append(f"n_class {cfg.n_class} outside 1..40 (NUM_CONC_a01-40)")
    if errs:
        raise ValueError("config validation failed:\n  - " + "\n  - ".join(errs))
    return cfg


def uniform_test_config(**overrides) -> Config:
    """em_uniform analogue: 40x40x10 @ 2 km, dt=10 s, periodic, transport-only
    (``test/em_uniform/namelist.input``). Sized down by default for tests."""
    cfg = Config(
        domain=DomainConfig(nx=40, ny=40, nz=10, dx=2000.0, dy=2000.0),
        dynamics=DynamicsConfig(dt=10.0, constant_velocity=True),
        boundary=BoundaryConfig(periodic_x=True, periodic_y=True),
        partmc=PartmcConfig(do_coagulation=False, do_emission=False,
                            do_deposition=False, do_mosaic=False),
    )
    return cfg.replace(**overrides) if overrides else cfg


def namelist_to_config(groups: dict) -> Config:
    """Minimal namelist-compatibility shim: accepts a dict of namelist groups
    (as parsed from a WRF ``namelist.input``) and maps the options the
    reference build consumes onto a :class:`Config`."""
    cfg = Config()
    dom = groups.get("domains", {})
    if dom:
        cfg = dataclasses.replace(cfg, domain=DomainConfig(
            nx=int(dom.get("e_we", 41)) - 1,
            ny=int(dom.get("e_sn", 41)) - 1,
            nz=int(dom.get("e_vert", 11)) - 1,
            dx=float(dom.get("dx", 2000.0)),
            dy=float(dom.get("dy", 2000.0)),
            ztop=float(dom.get("ztop", 10000.0)),
        ))
    dyn = groups.get("dynamics", {})
    if dyn:
        # WRF *_adv_opt integers: 0/1 PD, 2 monotonic, 3 WENO5, 4 WENO5+PD
        # (module_advect_em.F WENO variants :7963,:8647); WENO selections
        # switch the reconstruction order, the limiter stays PD.
        adv_map = {0: "pd", 1: "pd", 2: "mono", 3: "pd", 4: "pd"}
        h_ord: object = int(dyn.get("h_sca_adv_order", 5))
        v_ord: object = int(dyn.get("v_sca_adv_order", 3))
        if int(dyn.get("chem_adv_opt", 2)) in (3, 4) or \
                int(dyn.get("moist_adv_opt", 1)) in (3, 4):
            h_ord, v_ord = "weno5", "weno3"
        cfg = _replace_sub(cfg, "dynamics",
                           h_adv_order=h_ord,
                           v_adv_order=v_ord,
                           khdif=float(dyn.get("khdif", 0.0)),
                           kvdif=float(dyn.get("kvdif", 0.0)),
                           diff_opt=int(dyn.get("diff_opt", 0)),
                           km_opt={1: 4, 2: 2, 3: 4, 4: 4}.get(
                               int(dyn.get("km_opt", 4)), 4),
                           chem_adv_opt=adv_map.get(
                               int(dyn.get("chem_adv_opt", 2)), "mono"),
                           moist_adv_opt=adv_map.get(
                               int(dyn.get("moist_adv_opt", 1)), "pd"))
    tc = groups.get("time_control", {})
    if tc:
        cfg = _replace_sub(cfg, "time_control",
                           history_interval_s=60.0 * float(tc.get("history_interval", 10)),
                           restart=bool(tc.get("restart", False)))
    pmc = groups.get("partmc", {})
    if pmc:
        keep = {k: v for k, v in pmc.items()
                if k in {f.name for f in dataclasses.fields(PartmcConfig)}}
        cfg = _replace_sub(cfg, "partmc", **keep)
    bdy = groups.get("bdy_control", {})
    if bdy:
        cfg = _replace_sub(cfg, "boundary",
                           periodic_x=bool(bdy.get("periodic_x", True)),
                           periodic_y=bool(bdy.get("periodic_y", True)))
    return cfg
