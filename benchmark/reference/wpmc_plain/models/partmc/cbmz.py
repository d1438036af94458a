"""CBM-Z gas-phase photochemistry over the 77-species wrf_partmc gas list,
batched over grid cells (port of ``wrf_partmc_tpu/models/partmc/cbmz.py``).

Concentrations live in a dense ``[..., G]`` ppb tensor over all cells.  One
fixed-shape 2-stage Rosenbrock (ROS2, Verwer et al. 1999) advances every
cell in lockstep: the Jacobian is assembled analytically from two one-hot
contractions, and the Rosenbrock-W operator ``I - gamma h J`` is inverted
once per macro-step by block-Schur elimination (``fast_inv``), so every
stage solve is one batched matvec.  Photolysis is a clear-sky zenith-angle
power law (J = a * cos(chi)^b).

Every rate expression keeps the reference's left-to-right float32 order:
folding the Boltzmann-scale factors of M and H2O into the prefactors
underflows float32 (the reference guards the same with an
``optimization_barrier``), and ``K_DMS_OH_ADD``'s 1.7e-42 prefactor is
subnormal in float32, so nothing here may be built with flush-to-zero.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ... import constants as c

# ---------------------------------------------------------------------------
# The 77-species gas registry (names exactly as Registry/registry.chem:3986,
# molecular weights kg/mol)
# ---------------------------------------------------------------------------
CBMZ_GASES = (
    ("H2SO4", 98.0e-3), ("HNO3", 63.0e-3), ("HCl", 36.5e-3), ("NH3", 17.0e-3),
    ("NO", 30.0e-3), ("NO2", 46.0e-3), ("NO3", 62.0e-3), ("N2O5", 108.0e-3),
    ("HONO", 47.0e-3), ("HNO4", 79.0e-3), ("O3", 48.0e-3), ("O1D", 16.0e-3),
    ("O3P", 16.0e-3), ("OH", 17.0e-3), ("HO2", 33.0e-3), ("H2O2", 34.0e-3),
    ("CO", 28.0e-3), ("SO2", 64.0e-3), ("CH4", 16.0e-3), ("C2H6", 30.0e-3),
    ("CH3O2", 47.0e-3), ("ETHP", 61.0e-3), ("HCHO", 30.0e-3),
    ("CH3OH", 32.0e-3), ("ANOL", 46.0e-3), ("CH3OOH", 48.0e-3),
    ("ETHOOH", 62.0e-3), ("ALD2", 44.0e-3), ("HCOOH", 46.0e-3),
    ("RCOOH", 60.0e-3), ("C2O3", 75.0e-3), ("PAN", 121.0e-3),
    ("ARO1", 150.0e-3), ("ARO2", 150.0e-3), ("ALK1", 140.0e-3),
    ("OLE1", 140.0e-3), ("API1", 184.0e-3), ("API2", 184.0e-3),
    ("LIM1", 200.0e-3), ("LIM2", 200.0e-3), ("PAR", 14.0e-3),
    ("AONE", 58.0e-3), ("MGLY", 72.0e-3), ("ETH", 28.0e-3),
    ("OLET", 27.0e-3), ("OLEI", 27.0e-3), ("TOL", 92.0e-3), ("XYL", 106.0e-3),
    ("CRES", 108.0e-3), ("TO2", 173.0e-3), ("CRO", 107.0e-3),
    ("OPEN", 84.0e-3), ("ONIT", 119.0e-3), ("ROOH", 62.0e-3),
    ("RO2", 47.0e-3), ("ANO2", 89.0e-3), ("NAP", 119.0e-3), ("XO2", 47.0e-3),
    ("XPAR", 14.0e-3), ("ISOP", 68.0e-3), ("ISOPRD", 70.0e-3),
    ("ISOPP", 117.0e-3), ("ISOPN", 147.0e-3), ("ISOPO2", 117.0e-3),
    ("API", 136.0e-3), ("LIM", 136.0e-3), ("DMS", 62.0e-3), ("MSA", 96.0e-3),
    ("DMSO", 78.0e-3), ("DMSO2", 94.0e-3), ("CH3SO2H", 80.0e-3),
    ("CH3SCH2OO", 93.0e-3), ("CH3SO2", 79.0e-3), ("CH3SO3", 95.0e-3),
    ("CH3SO2OO", 111.0e-3), ("CH3SO2CH2OO", 125.0e-3), ("SULFHOX", 98.0e-3),
)

# number of N atoms carried by each NOy species (every reaction conserves
# this sum; NH3 is NHx, not NOy, and NAP is a nitrate-forming peroxy that
# picks its N up from NO)
N_ATOMS = {
    "HNO3": 1, "NO": 1, "NO2": 1, "NO3": 1, "N2O5": 2, "HONO": 1,
    "HNO4": 1, "PAN": 1, "ONIT": 1, "ISOPN": 1,
}


# ---------------------------------------------------------------------------
# Rate-expression builders.  Each returns f(T, M, H2O, J) -> k with T in K,
# M (air) and H2O in molec/cm3, J a dict of photolysis frequencies [1/s].
# Second-order rate constants are in cm3/molec/s (unit conversion to ppb
# happens in the solver); first-order in 1/s.
# ---------------------------------------------------------------------------
def ARR(A, C=0.0, B=0.0):
    return lambda T, M, H2O, J: A * (T / 300.0) ** B * torch.exp(-C / T)


def ARR_M(A, C=0.0, B=0.0):
    """Arrhenius times [M] (third-body folded in) -> effectively 1 order less."""
    return lambda T, M, H2O, J: A * (T / 300.0) ** B * torch.exp(-C / T) * M


def ARR_H2O(A, C=0.0):
    return lambda T, M, H2O, J: A * torch.exp(-C / T) * H2O


def TROE(k0_300, n, kinf_300, m):
    def f(T, M, H2O, J):
        k0 = k0_300 * (T / 300.0) ** (-n) * M
        kinf = kinf_300 * (T / 300.0) ** (-m)
        pr = k0 / kinf
        logf = 1.0 / (1.0 + torch.log10(pr) ** 2)
        return k0 / (1.0 + pr) * 0.6 ** logf
    return f


def TROE_REV(k0_300, n, kinf_300, m, A_eq, B_eq):
    """Thermal decomposition: k_troe / K_eq (K_eq = A_eq exp(B_eq/T) cm3)."""
    troe = TROE(k0_300, n, kinf_300, m)
    return lambda T, M, H2O, J: troe(T, M, H2O, J) / (A_eq * torch.exp(B_eq / T))


def PHOTO(name, scale=1.0):
    return lambda T, M, H2O, J: scale * J[name]


def K_OH_HNO3(T, M, H2O, J):
    # three-term pressure-dependent OH + HNO3 (JPL form)
    k0 = 2.4e-14 * torch.exp(460.0 / T)
    k2 = 2.7e-17 * torch.exp(2199.0 / T)
    k3m = 6.5e-34 * torch.exp(1335.0 / T) * M
    return k0 + k3m / (1.0 + k3m / k2)


def K_HO2_HO2(T, M, H2O, J):
    # water-vapor-enhanced HO2 self-reaction
    k = 3.0e-13 * torch.exp(460.0 / T) + 2.1e-33 * M * torch.exp(920.0 / T)
    return k * (1.0 + 1.4e-21 * H2O * torch.exp(2200.0 / T))


def K_CO_OH(T, M, H2O, J):
    return 1.5e-13 * (1.0 + 2.44e-20 * M)


def K_DMS_OH_ADD(T, M, H2O, J):
    # O2-dependent OH-addition channel (IUPAC form); O2 = 0.21 M.  The
    # 1.7e-42 prefactor is subnormal in float32 and must not be flushed.
    o2 = 0.21 * M
    num = 1.7e-42 * torch.exp(7810.0 / T) * o2
    den = 1.0 + 5.5e-31 * torch.exp(7460.0 / T) * o2
    return num / den


def K_O3P_O2(T, M, H2O, J):
    # O3P + O2 + M -> O3 folded to first order in O3P
    return 6.0e-34 * (T / 300.0) ** (-2.4) * M * 0.21 * M


# clear-sky photolysis parameterization J = a * max(cos chi, 0)^b
_J_PARAMS = {
    "no2":    (9.0e-3, 0.8),
    "no3":    (2.0e-1, 0.2),
    "hono":   (1.8e-3, 0.8),
    "hno3":   (7.0e-7, 1.5),
    "hno4":   (5.0e-6, 1.5),
    "n2o5":   (3.0e-5, 1.5),
    "o3p":    (5.0e-4, 0.8),
    "o1d":    (3.5e-5, 2.0),
    "h2o2":   (7.0e-6, 1.2),
    "ooh":    (5.0e-6, 1.2),
    "hchoa":  (3.0e-5, 1.4),   # radical channel
    "hchob":  (4.5e-5, 1.1),   # molecular channel
    "ald2":   (5.0e-6, 1.6),
    "open":   (2.7e-4, 1.4),
    "mgly":   (1.7e-4, 1.2),
    "aone":   (1.0e-6, 1.8),
    "isoprd": (1.0e-5, 1.4),
    "onit":   (1.5e-6, 1.5),
}


def photolysis_rates(cosz, j_scale=None):
    """J-values [1/s] for every photolysis channel from cos(solar zenith)
    (a float32 tensor).  ``j_scale``: optional per-cell actinic-flux factor
    (the aerosol attenuation, ``physics.radiation.photolysis_aerosol_factor``)
    applied to every channel."""
    mu = torch.clamp(cosz, min=0.0)
    js = 1.0 if j_scale is None else j_scale          # x * 1.0 is x exactly
    return {name: a * mu ** b * js for name, (a, b) in _J_PARAMS.items()}


def cos_zenith(lat_deg, lon_deg, day_of_year, utc_sec):
    """Cosine of the solar zenith angle (standard declination formula), in
    float32.  Arguments are float32 tensors or Python numbers."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    lat = torch.deg2rad(f32(lat_deg))
    decl = torch.deg2rad(f32(23.45)) * torch.sin(
        2.0 * torch.pi * (284.0 + f32(day_of_year)) / 365.0)
    hour = torch.remainder(f32(utc_sec) / 3600.0 + f32(lon_deg) / 15.0, 24.0)
    ha = torch.deg2rad(15.0 * (hour - 12.0))
    return (torch.sin(lat) * torch.sin(decl)
            + torch.cos(lat) * torch.cos(decl) * torch.cos(ha))


def solar_cos_zenith(dom, t: float) -> torch.Tensor:
    """cos(zenith) at model time ``t`` for the domain centre, with the
    reference's float32 solar time: utc = gmt*3600 + t, day = julian_day +
    utc // 86400, seconds = utc % 86400 (all float32)."""
    utc = np.float32(np.float32(dom.gmt * 3600.0) + np.float32(t))
    day = np.float32(np.float32(dom.julian_day) + np.floor_divide(utc, np.float32(86400.0)))
    return cos_zenith(dom.lat0, dom.lon0, day, np.remainder(utc, np.float32(86400.0)))


# ---------------------------------------------------------------------------
# The mechanism table: (rate_fn, reactant1, reactant2|None, {product: yield})
# ---------------------------------------------------------------------------
def _mechanism_table():
    R = []
    A = R.append
    # --- photolysis ---
    A((PHOTO("no2"), "NO2", None, {"NO": 1, "O3P": 1}))
    A((PHOTO("no3"), "NO3", None, {"NO2": 0.89, "O3P": 0.89, "NO": 0.11}))
    A((PHOTO("hono"), "HONO", None, {"OH": 1, "NO": 1}))
    A((PHOTO("hno3"), "HNO3", None, {"OH": 1, "NO2": 1}))
    A((PHOTO("hno4"), "HNO4", None, {"HO2": 1, "NO2": 1}))
    A((PHOTO("n2o5"), "N2O5", None, {"NO2": 1, "NO3": 1}))
    A((PHOTO("o3p"), "O3", None, {"O3P": 1}))
    A((PHOTO("o1d"), "O3", None, {"O1D": 1}))
    A((PHOTO("h2o2"), "H2O2", None, {"OH": 2}))
    # --- Ox / HOx / NOx inorganic core ---
    A((K_O3P_O2, "O3P", None, {"O3": 1}))
    A((ARR(6.5e-12, -120.0), "O3P", "NO2", {"NO": 1}))
    A((TROE(9.0e-32, 2.0, 2.2e-11, 0.0), "O3P", "NO2", {"NO3": 1}))
    A((TROE(9.0e-32, 1.5, 3.0e-11, 0.0), "O3P", "NO", {"NO2": 1}))
    A((ARR_M(2.38e-11, -100.0), "O1D", None, {"O3P": 1}))
    A((ARR_H2O(2.2e-10), "O1D", None, {"OH": 2}))
    A((ARR(3.0e-12, 1500.0), "O3", "NO", {"NO2": 1}))
    A((ARR(1.2e-13, 2450.0), "O3", "NO2", {"NO3": 1}))
    A((ARR(1.7e-12, 940.0), "O3", "OH", {"HO2": 1}))
    A((ARR(1.0e-14, 490.0), "O3", "HO2", {"OH": 1}))
    A((TROE(1.8e-30, 3.0, 2.8e-11, 0.0), "OH", "NO2", {"HNO3": 1}))
    A((TROE(7.0e-31, 2.6, 3.6e-11, 0.1), "OH", "NO", {"HONO": 1}))
    A((ARR(1.8e-11, 390.0), "OH", "HONO", {"NO2": 1}))
    A((K_OH_HNO3, "OH", "HNO3", {"NO3": 1}))
    A((ARR(1.3e-12, -380.0), "OH", "HNO4", {"NO2": 1}))
    A((ARR(4.8e-11, -250.0), "OH", "HO2", {}))
    A((ARR(1.8e-12), "OH", "H2O2", {"HO2": 1}))
    A((ARR(3.5e-12, -250.0), "HO2", "NO", {"OH": 1, "NO2": 1}))
    A((TROE(2.0e-31, 3.4, 2.9e-12, 1.1), "HO2", "NO2", {"HNO4": 1}))
    A((TROE_REV(2.0e-31, 3.4, 2.9e-12, 1.1, 2.1e-27, 10900.0),
       "HNO4", None, {"HO2": 1, "NO2": 1}))
    A((K_HO2_HO2, "HO2", "HO2", {"H2O2": 1}))
    A((ARR(1.5e-11, -170.0), "NO3", "NO", {"NO2": 2}))
    A((TROE(2.4e-30, 3.0, 1.6e-12, -0.1), "NO3", "NO2", {"N2O5": 1}))
    A((TROE_REV(2.4e-30, 3.0, 1.6e-12, -0.1, 2.7e-27, 11000.0),
       "N2O5", None, {"NO3": 1, "NO2": 1}))
    A((ARR_H2O(2.5e-22), "N2O5", None, {"HNO3": 2}))
    A((ARR(3.5e-12), "NO3", "HO2", {"OH": 0.7, "NO2": 0.7, "HNO3": 0.3}))
    A((ARR(8.5e-13, 2450.0), "NO3", "NO3", {"NO2": 2}))
    A((K_CO_OH, "CO", "OH", {"HO2": 1}))
    A((TROE(3.0e-31, 3.3, 1.5e-12, 0.0), "SO2", "OH",
       {"H2SO4": 1, "HO2": 1}))
    A((ARR(7.8e-12, 250.0), "HCl", "OH", {}))          # Cl chemistry lumped out
    A((ARR(1.7e-12, 710.0), "NH3", "OH", {}))
    # --- C1-C2 ---
    A((ARR(2.45e-12, 1775.0), "CH4", "OH", {"CH3O2": 1}))
    A((ARR(7.66e-12, 1020.0), "C2H6", "OH", {"ETHP": 1}))
    A((ARR(2.8e-12, -300.0), "CH3O2", "NO", {"HCHO": 1, "HO2": 1, "NO2": 1}))
    A((ARR(2.6e-12, -365.0), "ETHP", "NO", {"ALD2": 1, "HO2": 1, "NO2": 1}))
    A((ARR(1.3e-12), "CH3O2", "NO3", {"HCHO": 1, "HO2": 1, "NO2": 1}))
    A((ARR(4.1e-13, -750.0), "CH3O2", "HO2", {"CH3OOH": 1}))
    A((ARR(7.5e-13, -700.0), "ETHP", "HO2", {"ETHOOH": 1}))
    A((ARR(9.5e-14, -390.0), "CH3O2", "CH3O2",
       {"HCHO": 1.6, "HO2": 1.2, "CH3OH": 0.4}))
    A((PHOTO("ooh"), "CH3OOH", None, {"HCHO": 1, "HO2": 1, "OH": 1}))
    A((PHOTO("ooh"), "ETHOOH", None, {"ALD2": 1, "HO2": 1, "OH": 1}))
    A((ARR(3.8e-12, -200.0), "CH3OOH", "OH",
       {"CH3O2": 0.7, "HCHO": 0.3, "OH": 0.3}))
    A((ARR(3.8e-12, -200.0), "ETHOOH", "OH",
       {"ETHP": 0.5, "ALD2": 0.5, "OH": 0.5}))
    A((PHOTO("hchoa"), "HCHO", None, {"HO2": 2, "CO": 1}))
    A((PHOTO("hchob"), "HCHO", None, {"CO": 1}))
    A((ARR(5.5e-12, -125.0), "HCHO", "OH", {"HO2": 1, "CO": 1}))
    A((ARR(5.8e-16), "HCHO", "NO3", {"HNO3": 1, "HO2": 1, "CO": 1}))
    A((ARR(2.9e-12, 345.0), "CH3OH", "OH", {"HCHO": 1, "HO2": 1}))
    A((ARR(3.2e-12), "ANOL", "OH", {"ALD2": 1, "HO2": 1}))
    A((ARR(5.6e-12, -270.0), "ALD2", "OH", {"C2O3": 1}))
    A((ARR(1.4e-12, 1900.0), "ALD2", "NO3", {"C2O3": 1, "HNO3": 1}))
    A((PHOTO("ald2"), "ALD2", None, {"CH3O2": 1, "HO2": 1, "CO": 1}))
    A((ARR(8.1e-12, -270.0), "C2O3", "NO", {"CH3O2": 1, "NO2": 1}))
    A((TROE(9.7e-29, 5.6, 9.3e-12, 1.5), "C2O3", "NO2", {"PAN": 1}))
    A((TROE_REV(9.7e-29, 5.6, 9.3e-12, 1.5, 9.0e-29, 14000.0),
       "PAN", None, {"C2O3": 1, "NO2": 1}))
    A((ARR(4.3e-13, -1040.0), "C2O3", "HO2", {"RCOOH": 0.75, "O3": 0.25}))
    A((ARR(2.9e-12, -500.0), "C2O3", "C2O3", {"CH3O2": 2}))
    A((ARR(1.3e-12, -640.0), "C2O3", "CH3O2",
       {"HCHO": 1, "HO2": 1, "CH3O2": 1}))
    A((ARR(4.5e-13), "HCOOH", "OH", {"HO2": 1}))
    A((ARR(7.0e-13), "RCOOH", "OH", {"C2O3": 1}))
    # --- lumped higher organics (CBM structure) ---
    A((ARR(8.1e-13), "PAR", "OH",
       {"XO2": 0.87, "NAP": 0.13, "RO2": 0.76, "ALD2": 0.11, "HO2": 0.11,
        "XPAR": 0.2, "ALK1": 0.001}))
    A((ARR(2.7e-12, -360.0), "RO2", "NO",
       {"NO2": 0.9, "HO2": 0.9, "ALD2": 0.54, "AONE": 0.36, "ONIT": 0.1}))
    A((ARR(1.9e-13, -1300.0), "RO2", "HO2", {"ROOH": 1}))
    A((ARR(2.6e-12, -365.0), "XO2", "NO", {"NO2": 1}))
    A((ARR(7.5e-13, -700.0), "XO2", "HO2", {"ROOH": 1}))
    A((ARR(6.8e-14), "XO2", "XO2", {}))
    A((ARR(2.6e-12, -365.0), "NAP", "NO", {"ONIT": 1}))
    A((ARR(7.5e-13, -700.0), "NAP", "HO2", {"ROOH": 1}))
    A((ARR(8.0e-11), "XPAR", "PAR", {}))
    A((ARR(1.0e-4), "XPAR", None, {}))
    A((ARR(2.0e-12, -411.0), "ETH", "OH",
       {"XO2": 1, "HCHO": 1.56, "ALD2": 0.22, "HO2": 1}))
    A((ARR(1.2e-14, 2630.0), "ETH", "O3",
       {"HCHO": 1, "CO": 0.43, "HO2": 0.26, "OH": 0.12, "HCOOH": 0.37}))
    A((ARR(5.2e-12, -504.0), "OLET", "OH",
       {"XO2": 1, "HCHO": 1, "ALD2": 1, "HO2": 1, "XPAR": 1, "OLE1": 0.008}))
    A((ARR(1.0e-11, -550.0), "OLEI", "OH",
       {"XO2": 1, "ALD2": 2, "HO2": 1, "XPAR": 1}))
    A((ARR(6.5e-15, 1900.0), "OLET", "O3",
       {"ALD2": 0.5, "HCHO": 0.74, "CO": 0.33, "HO2": 0.44, "XO2": 0.22,
        "OH": 0.1, "HCOOH": 0.2, "RCOOH": 0.06, "XPAR": 1}))
    A((ARR(8.5e-15, 1520.0), "OLEI", "O3",
       {"ALD2": 1.0, "AONE": 0.3, "CO": 0.33, "HO2": 0.44, "OH": 0.1,
        "XPAR": 1}))
    A((ARR(1.1e-13), "OLET", "NO3",
       {"ONIT": 0.91, "XO2": 0.09, "NO2": 0.09, "ALD2": 0.09, "XPAR": 1}))
    A((ARR(3.2e-13), "OLEI", "NO3",
       {"ONIT": 0.91, "XO2": 0.09, "NO2": 0.09, "ALD2": 0.09, "XPAR": 1}))
    A((ARR(2.1e-12, -322.0), "TOL", "OH",
       {"HO2": 0.44, "XO2": 0.08, "CRES": 0.36, "TO2": 0.56, "ARO1": 0.07}))
    A((ARR(1.7e-11, -116.0), "XYL", "OH",
       {"HO2": 0.7, "XO2": 0.5, "CRES": 0.2, "MGLY": 0.8, "PAR": 1.1,
        "TO2": 0.3, "ARO2": 0.04}))
    A((ARR(8.1e-12), "TO2", "NO",
       {"NO2": 0.9, "HO2": 0.9, "OPEN": 0.9, "ONIT": 0.1}))
    A((ARR(4.1e-11), "CRES", "OH",
       {"CRO": 0.4, "XO2": 0.6, "HO2": 0.6, "OPEN": 0.3}))
    A((ARR(2.2e-11), "CRES", "NO3", {"CRO": 1, "HNO3": 1}))
    A((ARR(1.4e-11), "CRO", "NO2", {"ONIT": 1}))
    A((PHOTO("open"), "OPEN", None, {"C2O3": 1, "HO2": 1, "CO": 1}))
    A((ARR(3.0e-11), "OPEN", "OH",
       {"XO2": 1, "CO": 2, "HO2": 2, "HCHO": 1, "C2O3": 1}))
    A((ARR(5.4e-17, 500.0), "OPEN", "O3",
       {"ALD2": 0.03, "C2O3": 0.62, "HCHO": 0.7, "XO2": 0.03, "CO": 0.69,
        "OH": 0.08, "HO2": 0.76, "MGLY": 0.2}))
    A((PHOTO("mgly"), "MGLY", None, {"C2O3": 1, "HO2": 1, "CO": 1}))
    A((ARR(1.7e-11), "MGLY", "OH", {"XO2": 1, "C2O3": 1}))
    A((PHOTO("aone"), "AONE", None, {"C2O3": 1, "CH3O2": 1}))
    A((ARR(8.8e-12, 1320.0), "AONE", "OH", {"ANO2": 1}))
    A((ARR(2.6e-12, -365.0), "ANO2", "NO",
       {"C2O3": 1, "HCHO": 1, "NO2": 1}))
    A((ARR(7.5e-13, -700.0), "ANO2", "HO2", {"ROOH": 1}))
    A((ARR(1.5e-12), "ONIT", "OH", {"NO2": 1, "XO2": 1, "ALD2": 1}))
    A((PHOTO("onit"), "ONIT", None, {"NO2": 1, "HO2": 1, "ALD2": 1}))
    A((ARR(3.8e-12, -200.0), "ROOH", "OH",
       {"RO2": 0.6, "ALD2": 0.4, "OH": 0.4}))
    A((PHOTO("ooh"), "ROOH", None, {"OH": 1, "HO2": 1, "ALD2": 1}))
    # --- isoprene ---
    A((ARR(2.54e-11, -410.0), "ISOP", "OH", {"ISOPP": 1}))
    A((ARR(7.86e-15, 1913.0), "ISOP", "O3",
       {"HCHO": 0.6, "ISOPRD": 0.65, "OH": 0.27, "HO2": 0.07, "C2O3": 0.2,
        "ALD2": 0.15, "XO2": 0.2, "CO": 0.07}))
    A((ARR(3.03e-12, 448.0), "ISOP", "NO3", {"ISOPN": 1}))
    A((ARR(3.6e-11), "ISOP", "O3P", {"ISOPRD": 0.75, "HCHO": 0.25}))
    A((ARR(2.6e-12, -365.0), "ISOPP", "NO",
       {"ISOPRD": 0.91, "HO2": 0.91, "NO2": 0.91, "ONIT": 0.09}))
    A((ARR(7.5e-13, -700.0), "ISOPP", "HO2", {"ROOH": 1}))
    A((ARR(2.6e-12, -365.0), "ISOPN", "NO", {"ISOPRD": 1, "NO2": 2}))
    A((ARR(7.5e-13, -700.0), "ISOPN", "HO2", {"ONIT": 1}))
    A((ARR(3.36e-11), "ISOPRD", "OH", {"ISOPO2": 0.5, "C2O3": 0.5}))
    A((ARR(7.1e-18), "ISOPRD", "O3",
       {"OH": 0.27, "HO2": 0.1, "C2O3": 0.11, "XO2": 0.07, "MGLY": 0.05,
        "ALD2": 0.39, "CO": 0.36, "HCHO": 0.15}))
    A((PHOTO("isoprd"), "ISOPRD", None,
       {"C2O3": 0.97, "HO2": 0.33, "CO": 0.33, "CH3O2": 0.7}))
    A((ARR(1.0e-15), "ISOPRD", "NO3", {"HNO3": 1, "C2O3": 1}))
    A((ARR(2.6e-12, -365.0), "ISOPO2", "NO",
       {"NO2": 1, "HO2": 1, "CO": 0.59, "ALD2": 0.55, "HCHO": 0.25,
        "MGLY": 0.34}))
    A((ARR(7.5e-13, -700.0), "ISOPO2", "HO2", {"ROOH": 1}))
    # --- monoterpene SOA precursors ---
    A((ARR(1.21e-11, -444.0), "API", "OH",
       {"API1": 0.8, "API2": 0.2, "XO2": 1, "HO2": 1}))
    A((ARR(1.01e-15, 732.0), "API", "O3",
       {"API1": 0.6, "API2": 0.4, "OH": 0.85, "HO2": 0.1}))
    A((ARR(1.19e-12, -490.0), "API", "NO3", {"ONIT": 1}))
    A((ARR(4.2e-11), "LIM", "OH",
       {"LIM1": 0.6, "LIM2": 0.4, "XO2": 1, "HO2": 1}))
    A((ARR(2.95e-15, 783.0), "LIM", "O3",
       {"LIM1": 0.5, "LIM2": 0.5, "OH": 0.85, "HO2": 0.1}))
    A((ARR(1.22e-11), "LIM", "NO3", {"ONIT": 1}))
    # --- DMS marine sulfur block ---
    A((ARR(1.2e-11, 260.0), "DMS", "OH", {"CH3SCH2OO": 1}))
    A((K_DMS_OH_ADD, "DMS", "OH", {"DMSO": 1}))
    A((ARR(1.9e-13, -520.0), "DMS", "NO3", {"CH3SCH2OO": 1, "HNO3": 1}))
    A((ARR(2.6e-12, -365.0), "CH3SCH2OO", "NO",
       {"HCHO": 1, "CH3SO2": 1, "NO2": 1}))
    A((ARR(7.5e-13, -700.0), "CH3SCH2OO", "HO2",
       {"CH3SO2H": 1, "HCHO": 1}))
    A((ARR(8.7e-11), "DMSO", "OH", {"CH3SO2H": 0.95, "DMSO2": 0.05}))
    A((ARR(1.0e-13), "DMSO2", "OH", {"CH3SO2CH2OO": 1}))
    A((ARR(2.6e-12, -365.0), "CH3SO2CH2OO", "NO",
       {"NO2": 1, "HCHO": 1, "CH3SO2": 1}))
    A((ARR(9.0e-11), "CH3SO2H", "OH", {"CH3SO2": 1}))
    A((ARR(5.0e13, 9673.0), "CH3SO2", None, {"SO2": 1, "CH3O2": 1}))
    A((ARR(6.3e-13), "CH3SO2", "O3", {"CH3SO3": 1}))
    A((ARR(2.2e-11), "CH3SO2", "NO2", {"CH3SO3": 1, "NO": 1}))
    A((ARR_M(5.5e-19), "CH3SO2", None, {"CH3SO2OO": 1}))   # +O2 folded
    A((ARR(3.5e10, 3560.0), "CH3SO2OO", None, {"CH3SO2": 1}))
    A((ARR(1.0e-11), "CH3SO2OO", "NO", {"CH3SO3": 1, "NO2": 1}))
    A((ARR(2.2e-11), "CH3SO2OO", "HO2", {"CH3SO3": 1, "OH": 1}))
    A((ARR(1.6e-15), "CH3SO3", "HCHO", {"MSA": 1, "HO2": 1, "CO": 1}))
    A((ARR(5.0e-11), "CH3SO3", "HO2", {"MSA": 1}))
    A((ARR(1.1e3, 6100.0), "CH3SO3", None, {"SULFHOX": 1, "CH3O2": 1}))
    return R


@dataclass(frozen=True)
class Mechanism:
    """Static mechanism tables."""
    net: torch.Tensor        # [R, S] net stoichiometry (products - reactants)
    e1: torch.Tensor         # [R, S] one-hot of reactant 1
    e2: torch.Tensor         # [R, S] one-hot of reactant 2 (zero row if none)
    i1: torch.Tensor         # [R] int32 index of reactant 1
    i2: torch.Tensor         # [R] int32 index of reactant 2 (0 if none)
    has2: torch.Tensor       # [R] bool second reactant present
    rate_fns: tuple = ()
    names: tuple = ()

    @property
    def n_rxn(self) -> int:
        return len(self.rate_fns)

    @property
    def n_spec(self) -> int:
        return len(self.names)


def build_mechanism(gas_names=None, device="cpu") -> Mechanism:
    names = tuple(gas_names) if gas_names is not None else tuple(
        g[0] for g in CBMZ_GASES)
    idx = {n: i for i, n in enumerate(names)}
    table = _mechanism_table()
    S, R = len(names), len(table)
    net = np.zeros((R, S), np.float32)
    e1 = np.zeros((R, S), np.float32)
    e2 = np.zeros((R, S), np.float32)
    i1 = np.zeros(R, np.int32)
    i2 = np.zeros(R, np.int32)
    has2 = np.zeros(R, bool)
    for r, (fn, r1, r2, prods) in enumerate(table):
        i1[r] = idx[r1]
        e1[r, idx[r1]] = 1.0
        net[r, idx[r1]] -= 1.0
        if r2 is not None:
            i2[r] = idx[r2]
            e2[r, idx[r2]] = 1.0
            net[r, idx[r2]] -= 1.0
            has2[r] = True
        for p, y in prods.items():
            net[r, idx[p]] += y
    t = lambda a: torch.as_tensor(a, device=device)
    return Mechanism(net=t(net), e1=t(e1), e2=t(e2), i1=t(i1), i2=t(i2),
                     has2=t(has2), rate_fns=tuple(r[0] for r in table),
                     names=names)


# ---------------------------------------------------------------------------
# Batched ROS2 solver (all cells advance in lockstep)
# ---------------------------------------------------------------------------
def rate_coefficients(mech: Mechanism, temp, pressure, rh, cosz, j_scale=None):
    """Per-cell rate coefficients in ppb-space: k2nd * M * 1e-9 for
    two-reactant rows, k as-is for first-order rows.  Returns [..., R].
    ``j_scale``: per-cell actinic-flux factor (see :func:`photolysis_rates`)."""
    T = temp.to(torch.float32)
    p = pressure.to(torch.float32)
    M = p / (c.BOLTZMANN * T) * 1e-6          # molec/cm3
    # water vapor number density from RH (Tetens over liquid)
    esat = 610.78 * torch.exp(17.27 * (T - 273.15) / (T - 35.85))
    H2O = rh * esat / (c.BOLTZMANN * T) * 1e-6
    J = photolysis_rates(cosz, j_scale)
    ks = [fn(T, M, H2O, J) for fn in mech.rate_fns]
    k = torch.stack([torch.broadcast_to(ki, T.shape) for ki in ks], dim=-1)
    conv = torch.where(mech.has2, M[..., None] * 1e-9, 1.0)
    return (k * conv).to(torch.float32)


def _reactants(mech: Mechanism, conc):
    c1 = torch.index_select(conc, -1, mech.i1)
    c2 = torch.where(mech.has2, torch.index_select(conc, -1, mech.i2), 1.0)
    return c1, c2


def production_rates(mech: Mechanism, conc, k_ppb):
    """dc/dt [ppb/s] for conc [..., S]."""
    c1, c2 = _reactants(mech, conc)
    vel = k_ppb * c1 * c2
    return vel @ mech.net


def jacobian(mech: Mechanism, conc, k_ppb):
    """Analytic [..., S, S] Jacobian d(dc/dt)/dc via one-hot contractions:
    J[t, s] = sum_r g1[r] net[r, t] e1[r, s] + g2[r] net[r, t] e2[r, s].
    Both contractions run as one float32 GEMM of [..., 2R] against the
    [2R, S*S] table of net x one-hot products (exact, the one-hots being
    0/1), so no [..., R, S] intermediate is formed."""
    c1, c2 = _reactants(mech, conc)
    g1 = k_ppb * c2                                   # d vel / d c[i1]
    g2 = torch.where(mech.has2, k_ppb * c1, 0.0)      # d vel / d c[i2]
    R, S = mech.net.shape
    outer = lambda e: (mech.net[:, :, None] * e[:, None, :]).reshape(R, S * S)
    J = torch.cat([g1, g2], dim=-1) @ torch.cat([outer(mech.e1), outer(mech.e2)])
    return J.reshape(*conc.shape[:-1], S, S)


_ROS_GAMMA = 1.0 + 1.0 / math.sqrt(2.0)

# Cells per slice of :func:`cbmz_step`: at S = 77 the per-cell [S, S]
# operators take 23 KB, 194 MB for a slice of 8192 cells.
CELL_BLOCK = 8192


def _gj_inv_small(A):
    """Unrolled Gauss-Jordan inverse with partial pivoting for small
    [..., S, S] blocks: S sweeps over a [..., S, 2S] tableau, the pivot row
    picked per batch element by a masked argmax (the first maximum on ties,
    as ``jnp.argmax``) and swapped in with where-masks."""
    S = A.shape[-1]
    eye = torch.eye(S, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, eye], dim=-1)                       # [..., S, 2S]
    rows = torch.arange(S, device=A.device)
    for i in range(S):
        col = torch.abs(M[..., :, i])                     # [..., S]
        col = torch.where(rows >= i, col, -1.0)
        r = torch.argmax(col, dim=-1)                     # [...]
        sel = (rows == r[..., None])[..., :, None]        # [..., S, 1]
        row_r = torch.sum(torch.where(sel, M, 0.0), dim=-2, keepdim=True)
        row_i = M[..., i:i + 1, :]
        M = torch.where(sel, row_i, M)                    # old row i -> r
        piv = row_r / row_r[..., :, i:i + 1]              # [..., 1, 2S]
        M = M - M[..., :, i:i + 1] * piv
        M = torch.where((rows == i)[:, None], piv, M)
    return M[..., S:]


def _block_inv(A, min_block: int = 16):
    """Batched inverse of [..., S, S] by recursive 2x2 block (Schur
    complement) elimination, every step a batched float32 matmul.  No
    pivoting: A = I - gamma h J of this mechanism is dominated by the
    identity and first-order losses, and one Newton-Schulz pass in
    :func:`fast_inv` refines the result."""
    S = A.shape[-1]
    if S <= min_block:
        return _gj_inv_small(A)
    mm = torch.matmul
    k = S // 2
    A11, A12 = A[..., :k, :k], A[..., :k, k:]
    A21, A22 = A[..., k:, :k], A[..., k:, k:]
    iA11 = _block_inv(A11, min_block)
    S22 = A22 - mm(A21, mm(iA11, A12))
    iS22 = _block_inv(S22, min_block)
    iA11_A12 = mm(iA11, A12)
    B12 = -mm(iA11_A12, iS22)
    B21 = -mm(iS22, mm(A21, iA11))
    B11 = iA11 - mm(iA11_A12, B21)
    return torch.cat([torch.cat([B11, B12], dim=-1),
                      torch.cat([B21, iS22], dim=-1)], dim=-2)


def fast_inv(A, ns_iters: int = 1):
    """Batched inverse: block-Schur elimination + ``ns_iters`` Newton-Schulz
    refinements X <- X (2I - A X)."""
    X = _block_inv(A)
    eye2 = 2.0 * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    for _ in range(ns_iters):
        X = torch.matmul(X, eye2 - torch.matmul(A, X))
    return X


def _f32(x) -> float:
    return float(np.float32(x))


def ros2_operator(mech: Mechanism, conc, k_ppb, h: float):
    """A = I - gamma h J, with gamma h rounded to float32 as the reference
    forms it."""
    S = conc.shape[-1]
    gh = _f32(np.float32(_ROS_GAMMA) * np.float32(h))
    eye = torch.eye(S, dtype=conc.dtype, device=conc.device)
    return eye - gh * jacobian(mech, conc, k_ppb)


def ros2_substep(mech: Mechanism, conc, k_ppb, h: float):
    """One L-stable 2-stage Rosenbrock step (Verwer et al. 1999) with the
    operator refactorized from the current state."""
    A = ros2_operator(mech, conc, k_ppb, h)
    f1 = production_rates(mech, conc, k_ppb)
    k1 = torch.linalg.solve(A, f1[..., None])[..., 0]
    f2 = production_rates(mech, torch.clamp(conc + h * k1, min=0.0), k_ppb)
    k2 = torch.linalg.solve(A, (f2 - 2.0 * k1)[..., None])[..., 0]
    out = conc + 1.5 * h * k1 + 0.5 * h * k2
    return torch.clamp(out, min=0.0)


def ros2_substep_w(mech: Mechanism, conc, k_ppb, h: float, a_inv):
    """ROS2 stage update against a frozen inverted operator (Rosenbrock-W):
    each stage solve is one batched [S, S] @ [S] matvec."""
    f1 = production_rates(mech, conc, k_ppb)
    k1 = torch.matmul(a_inv, f1[..., None])[..., 0]
    f2 = production_rates(mech, torch.clamp(conc + h * k1, min=0.0), k_ppb)
    k2 = torch.matmul(a_inv, (f2 - 2.0 * k1)[..., None])[..., 0]
    out = conc + 1.5 * h * k1 + 0.5 * h * k2
    return torch.clamp(out, min=0.0)


def cbmz_step(mech: Mechanism, gas_ppb, temp, pressure, rh, cosz, dt,
              n_sub: int = 6, w_method: bool = True,
              cell_block: int = CELL_BLOCK, j_scale=None):
    """Advance the gas mechanism by dt over every cell.

    gas_ppb: [..., S]; temp/pressure/rh/cosz: tensors or numbers broadcast
    over the cells.  Returns updated [..., S] ppb.

    ``w_method`` (default): Rosenbrock-W, the operator inverted once per
    macro-step from the initial state and reused by every substep.
    ``cell_block``: cells are solved in slices of at most this many, so the
    dense per-cell [S, S] operators (23 KB per cell at S = 77) exist for one
    slice at a time.  The slices are not padded (the reference pads its last
    block with zeros and slices the results away).  ``j_scale``: per-cell
    actinic-flux factor (1 when not given, as the reference broadcasts it)."""
    cell = tuple(gas_ppb.shape[:-1])
    S = gas_ppb.shape[-1]
    dev = gas_ppb.device
    full = lambda x: torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.float32, device=dev), cell).reshape(-1)
    N = math.prod(cell)
    h = _f32(np.float32(dt) / np.float32(n_sub))
    conc0 = gas_ppb.to(torch.float32).reshape(N, S)
    T, P, RH, MU = full(temp), full(pressure), full(rh), full(cosz)
    JS = (torch.ones(N, dtype=torch.float32, device=dev) if j_scale is None
          else full(j_scale))

    def solve_block(sl):
        conc = conc0[sl]
        k_ppb = rate_coefficients(mech, T[sl], P[sl], RH[sl], MU[sl], JS[sl])
        if w_method:
            a_inv = fast_inv(ros2_operator(mech, conc, k_ppb, h))
            for _ in range(n_sub):
                conc = ros2_substep_w(mech, conc, k_ppb, h, a_inv)
        else:
            for _ in range(n_sub):
                conc = ros2_substep(mech, conc, k_ppb, h)
        return conc

    out = torch.cat([solve_block(slice(s, min(s + cell_block, N)))
                     for s in range(0, N, cell_block)])
    return out.reshape(*cell, S)
