"""Physical constants of the port.

The port's own copy of ``wrf_partmc_tpu/constants.py``: the reference's
PartMC ``constants.f90`` (used as ``const%grav`` etc. at e.g.
``interface/wrf_pmc_dep_aero.F90:321-322``) and WRF's
``share/module_model_constants.F``, as one flat module of Python floats.
``tests/test_torch_config.py`` holds every value equal to the JAX
package's.
"""

# --- dynamics / thermodynamics (WRF module_model_constants equivalents) ---
GRAV = 9.81                 # gravitational acceleration [m s-2]
R_D = 287.0                 # dry-air gas constant [J kg-1 K-1]
R_V = 461.6                 # water-vapor gas constant [J kg-1 K-1]
CP = 7.0 * R_D / 2.0        # dry-air heat capacity, const p [J kg-1 K-1]
CV = CP - R_D               # dry-air heat capacity, const v [J kg-1 K-1]
P0 = 1.0e5                  # reference pressure [Pa]
T0 = 300.0                  # base-state surface potential temperature [K]
GAMMA = CP / CV             # heat-capacity ratio
KAPPA = R_D / CP            # Poisson constant
EPS_VAP = R_D / R_V         # ratio of gas constants (0.622)
KARMAN = 0.4                # von Karman constant

# --- aerosol microphysics (PartMC constants.f90 equivalents) ---
BOLTZMANN = 1.380649e-23    # Boltzmann constant [J K-1]
AVOGADRO = 6.02214076e23    # Avogadro's number [mol-1]
UNIV_GAS_CONST = 8.314462618  # universal gas constant [J mol-1 K-1]
AIR_DYN_VISC = 1.78e-5      # dynamic viscosity of air [kg m-1 s-1]
AIR_MOLEC_WEIGHT = 28.966e-3  # molecular weight of dry air [kg mol-1]
WATER_DENSITY = 1000.0      # density of liquid water [kg m-3]
WATER_MOLEC_WEIGHT = 18.015e-3  # molecular weight of water [kg mol-1]
WATER_SURF_ENERGY = 0.073   # surface tension of water/air [J m-2]
WATER_LATENT_HEAT = 2.501e6  # latent heat of vaporization [J kg-1]
ACCOM_COEFF = 1.0           # mass accommodation coefficient [-]
MEAN_FREE_PATH_REF = 6.51e-8  # air mean free path at 1 atm, 293 K [m]
STD_PRESSURE = 101325.0     # standard atmosphere [Pa]

import math as _math

PI = _math.pi
ICE_LATENT_HEAT_SUB = 2.834e6   # latent heat of sublimation [J kg-1]
ICE_LATENT_HEAT_FUS = 3.34e5    # latent heat of fusion [J kg-1]
T_FREEZE = 273.15               # freezing point [K]
T_HOMOG = 238.15                # homogeneous freezing threshold [K]
