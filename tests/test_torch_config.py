"""The port's own ``config`` and ``constants`` against the JAX package's:
the same dataclasses, field names and defaults, the same constants, equal
trees from ``uniform_test_config`` and ``namelist_to_config`` (through
``convert.config_from_reference``), and the same refusals with the same
messages from ``validate_config``.  Also: the entry points default to the
card and raise on a host without one."""

import dataclasses

import pytest
import torch

from wrf_partmc_tpu import config as jconfig
from wrf_partmc_tpu import constants as jconstants

from wrf_partmc_tpu_torch import config, constants
from wrf_partmc_tpu_torch.convert import config_from_reference

CLASSES = ["DomainConfig", "DynamicsConfig", "BoundaryConfig", "PartmcConfig",
           "TimeControlConfig", "Config"]
CONSTANTS = sorted(n for n in vars(jconstants) if n.isupper())


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults(name):
    ref, ours = getattr(jconfig, name), getattr(config, name)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    assert ours.__dataclass_params__.frozen
    hash(ours())


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant(name):
    assert getattr(constants, name) == getattr(jconstants, name)


def test_no_extra_constants():
    assert sorted(n for n in vars(constants) if n.isupper()) == CONSTANTS


UNIFORM = {
    "default": lambda m: {},
    "widths": lambda m: dict(n_class=8, n_chem_gas=77, n_moist=10, n_moist_mass=6),
    "domain": lambda m: dict(domain=m.DomainConfig(nx=12, ny=12, nz=4, dx=2000.0,
                                                   dy=2000.0, ztop=2000.0)),
}


@pytest.mark.parametrize("case", sorted(UNIFORM))
def test_uniform_test_config(case):
    ref = jconfig.uniform_test_config(**UNIFORM[case](jconfig))
    ours = config.uniform_test_config(**UNIFORM[case](config))
    assert type(ours) is config.Config
    assert config_from_reference(ref) == ours


# namelist groups as parsed from a WRF namelist.input (tests/test_core.py,
# tests/test_io_run.py) and the option mappings namelist_to_config makes
NAMELISTS = {
    "empty": {},
    "core": {"domains": {"e_we": 11, "e_sn": 21, "e_vert": 6, "dx": 500.0, "dy": 500.0},
             "partmc": {"num_particles": 32, "do_coagulation": False}},
    "em_uniform": {"time_control": {"history_interval": 10, "restart": False},
                   "domains": {"e_we": 41, "e_sn": 41, "e_vert": 11, "dx": 2000.0,
                               "dy": 2000},
                   "partmc": {"num_particles": 1000, "do_coagulation": True,
                              "partmc_specfile": "test.spec"}},
    "weno_bdy": {"dynamics": {"chem_adv_opt": 3, "moist_adv_opt": 1, "km_opt": 2,
                              "diff_opt": 2, "khdif": 10.0},
                 "bdy_control": {"periodic_x": False, "periodic_y": True}},
    "mono": {"dynamics": {"chem_adv_opt": 2, "moist_adv_opt": 2, "h_sca_adv_order": 3,
                          "v_sca_adv_order": 2}},
}


@pytest.mark.parametrize("case", sorted(NAMELISTS))
def test_namelist_to_config(case):
    ref = jconfig.namelist_to_config(NAMELISTS[case])
    ours = config.namelist_to_config(NAMELISTS[case])
    assert type(ours) is config.Config
    assert config_from_reference(ref) == ours


BAD = {
    "domain": dict(domain=dict(nx=2)),
    "dt": dict(dynamics=dict(dt=-1.0)),
    "acoustic_cfl": dict(dynamics=dict(dt=60.0, n_sound=1)),
    "lsm_without_pbl": dict(dynamics=dict(sf_surface_physics=2)),
    "morrison_moist": dict(dynamics=dict(mp_physics=10)),
    "adv_order": dict(dynamics=dict(h_adv_order=7)),
    "capacity": dict(partmc=dict(max_particles=8, num_particles=16)),
    "chem_dt": dict(partmc=dict(partmc_chem_dt=15.0)),
    "chem_mech": dict(partmc=dict(chem_mech="racm")),
    "mosaic_gases": dict(partmc=dict(do_mosaic=True)),
    "open_and_periodic": dict(boundary=dict(open_xs=True)),
    "n_class": dict(top=dict(n_class=41)),
    "several": dict(domain=dict(nx=1), partmc=dict(seasalt_param=3, num_bins=1)),
}


def _bad(mod, case):
    cfg = mod.uniform_test_config()
    for group, kw in BAD[case].items():
        if group == "top":
            cfg = cfg.replace(**kw)
        else:
            cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group), **kw)})
    return cfg


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_config_refuses_alike(case):
    with pytest.raises(ValueError) as ref:
        jconfig.validate_config(_bad(jconfig, case))
    with pytest.raises(ValueError) as ours:
        config.validate_config(_bad(config, case))
    assert str(ours.value) == str(ref.value)


def test_validate_config_accepts_alike():
    for mod in (jconfig, config):
        cfg = mod.uniform_test_config()
        assert mod.validate_config(cfg) is cfg


def test_config_from_reference_both_ways_and_refuses_other_fields():
    ours = config.uniform_test_config(n_class=8)
    back = config_from_reference(ours, jconfig.Config)
    assert type(back) is jconfig.Config and type(back.partmc) is jconfig.PartmcConfig
    assert back == jconfig.uniform_test_config(n_class=8)

    @dataclasses.dataclass(frozen=True)
    class Other:
        nx: int = 4

    with pytest.raises(ValueError, match="fields differ"):
        config_from_reference(Other(), config.DomainConfig)


@pytest.mark.parametrize("entry", ["build", "build_cares_shape"])
def test_entry_points_default_to_the_card(entry):
    """Called without ``device``, the entry points build on ``cuda``; on a
    host without CUDA they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    from wrf_partmc_tpu_torch.cares import build_cares_shape
    from wrf_partmc_tpu_torch.entry import build

    fn = {"build": lambda: build(12, 12, 4, n_part=16, cap=48),
          "build_cares_shape": lambda: build_cares_shape(12, 10, 8, n_part=16, cap=32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn[entry]()
