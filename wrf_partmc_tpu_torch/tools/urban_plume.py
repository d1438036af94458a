"""The PartMC urban-plume scenario (Riemer, West, Zaveri & Easter, JGR 114
D09202, 2009) for the port's 0-D box model.

The port's own copy of the repository's ``tools/urban_plume.py``: the same
tables and scenario, built from the port's modules on ``device``.  The
inputs follow the reference's copy of the scenario
(``WRFV3/test/em_scm_xy/``): the bimodal remote-continental initial aerosol
(``aero_init_dist.dat``, Seinfeld & Pandis p. 430) with OC/SO4/NH4 =
1.375/1/0.375 mass fractions; diesel, gasoline and cooking aerosol
emissions (``aero_emit_dist.dat`` + ``aero_emit_comp_*.dat``); the hourly
SMOKE-derived gas emission fluxes (``gas_emit.dat``, x0.5 scale, on for
the first 12 h as in the published schedule); background dilution at
1.5e-5 s^-1 toward the remote-continental background (``aero_back.dat``,
``gas_back.dat``).  The run starts at 06:00 LST; the mixing height grows
290 -> 1400 m through the morning (entrainment dilution (dH/dt)/H added to
the background rate) and holds the residual-layer value overnight.

    python -m wrf_partmc_tpu_torch.tools.urban_plume [--device cpu] [--hours 24]

runs the parcel (on ``cuda`` unless ``--device cpu``) and prints one JSON
line of trajectories an hour.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np
import torch

# ---- gas emissions [mol m^-2 s^-1], hourly from 06:00 LST, BEFORE the 0.5
# scenario scale (WRFV3/test/em_scm_xy/gas_emit.dat, first 24 columns) ----
GAS_EMIT = {
    'SO2': [4.234e-09, 5.481e-09, 5.089e-09, 5.199e-09, 5.221e-09, 5.284e-09, 5.244e-09, 5.280e-09, 5.560e-09, 5.343e-09, 4.480e-09, 3.858e-09, 3.823e-09, 3.607e-09, 3.533e-09, 3.438e-09, 2.866e-09, 2.667e-09, 2.636e-09, 2.573e-09, 2.558e-09, 2.573e-09, 2.715e-09, 3.170e-09],
    'NO2': [1.512e-09, 1.667e-09, 1.531e-09, 1.641e-09, 1.686e-09, 1.761e-09, 1.701e-09, 1.775e-09, 1.707e-09, 1.992e-09, 1.654e-09, 1.467e-09, 1.190e-09, 9.675e-10, 8.990e-10, 7.685e-10, 4.816e-10, 4.437e-10, 3.984e-10, 3.078e-10, 2.960e-10, 3.160e-10, 4.936e-10, 9.505e-10],
    'NO': [2.875e-08, 3.169e-08, 2.913e-08, 3.118e-08, 3.205e-08, 3.350e-08, 3.234e-08, 3.376e-08, 3.244e-08, 3.788e-08, 3.145e-08, 2.788e-08, 2.262e-08, 1.840e-08, 1.709e-08, 1.462e-08, 9.160e-09, 8.435e-09, 7.575e-09, 5.855e-09, 5.625e-09, 6.010e-09, 9.385e-09, 1.808e-08],
    'NH3': [8.930e-09, 8.705e-09, 1.639e-08, 1.466e-08, 1.641e-08, 1.881e-08, 1.650e-08, 1.805e-08, 1.347e-08, 6.745e-09, 5.415e-09, 2.553e-09, 2.087e-09, 2.289e-09, 2.727e-09, 2.738e-09, 9.960e-10, 2.707e-09, 9.840e-10, 9.675e-10, 9.905e-10, 1.035e-09, 1.083e-09, 2.747e-09],
    'CO': [7.839e-07, 5.837e-07, 4.154e-07, 4.458e-07, 4.657e-07, 4.912e-07, 4.651e-07, 4.907e-07, 6.938e-07, 8.850e-07, 8.135e-07, 4.573e-07, 3.349e-07, 2.437e-07, 2.148e-07, 1.662e-07, 8.037e-08, 7.841e-08, 6.411e-08, 2.551e-08, 2.056e-08, 3.058e-08, 1.083e-07, 3.938e-07],
    'ALD2': [1.702e-09, 1.283e-09, 9.397e-10, 1.024e-09, 1.076e-09, 1.132e-09, 1.068e-09, 1.130e-09, 1.651e-09, 2.132e-09, 1.985e-09, 1.081e-09, 7.847e-10, 5.676e-10, 5.003e-10, 3.838e-10, 1.784e-10, 1.766e-10, 1.430e-10, 5.173e-11, 4.028e-11, 6.349e-11, 2.428e-10, 8.716e-10],
    'HCHO': [4.061e-09, 3.225e-09, 2.440e-09, 2.639e-09, 2.754e-09, 2.888e-09, 2.741e-09, 2.885e-09, 4.088e-09, 5.186e-09, 4.702e-09, 2.601e-09, 1.923e-09, 1.412e-09, 1.252e-09, 9.776e-10, 4.687e-10, 4.657e-10, 3.836e-10, 1.717e-10, 1.448e-10, 1.976e-10, 6.193e-10, 2.090e-09],
    'ETH': [1.849e-08, 1.391e-08, 1.010e-08, 1.095e-08, 1.148e-08, 1.209e-08, 1.142e-08, 1.205e-08, 1.806e-08, 2.320e-08, 2.149e-08, 1.146e-08, 8.384e-09, 6.124e-09, 5.414e-09, 4.119e-09, 1.953e-09, 1.927e-09, 1.575e-09, 6.164e-10, 4.973e-10, 7.420e-10, 2.653e-09, 9.477e-09],
    'OLEI': [5.948e-09, 4.573e-09, 3.374e-09, 3.668e-09, 3.851e-09, 4.050e-09, 3.841e-09, 4.052e-09, 6.094e-09, 7.795e-09, 7.215e-09, 3.738e-09, 2.718e-09, 1.973e-09, 1.729e-09, 1.338e-09, 6.333e-10, 6.394e-10, 5.126e-10, 2.089e-10, 1.708e-10, 2.480e-10, 8.947e-10, 3.057e-09],
    'OLET': [5.948e-09, 4.573e-09, 3.374e-09, 3.668e-09, 3.851e-09, 4.050e-09, 3.841e-09, 4.052e-09, 6.094e-09, 7.795e-09, 7.215e-09, 3.738e-09, 2.718e-09, 1.973e-09, 1.729e-09, 1.338e-09, 6.333e-10, 6.394e-10, 5.126e-10, 2.089e-10, 1.708e-10, 2.480e-10, 8.947e-10, 3.057e-09],
    'TOL': [6.101e-09, 8.706e-09, 7.755e-09, 8.024e-09, 8.202e-09, 8.410e-09, 8.218e-09, 8.407e-09, 1.020e-08, 1.139e-08, 7.338e-09, 4.184e-09, 3.078e-09, 2.283e-09, 2.010e-09, 1.575e-09, 8.966e-10, 6.705e-10, 5.395e-10, 2.462e-10, 2.106e-10, 2.852e-10, 9.300e-10, 3.144e-09],
    'XYL': [5.599e-09, 4.774e-09, 3.660e-09, 3.909e-09, 4.060e-09, 4.239e-09, 4.060e-09, 4.257e-09, 6.036e-09, 7.448e-09, 6.452e-09, 3.435e-09, 2.525e-09, 1.859e-09, 1.650e-09, 1.302e-09, 6.852e-10, 6.773e-10, 5.437e-10, 2.697e-10, 2.358e-10, 3.059e-10, 8.552e-10, 2.861e-10],
    'AONE': [7.825e-10, 2.858e-09, 2.938e-09, 2.947e-09, 2.948e-09, 2.951e-09, 2.947e-09, 2.954e-09, 3.032e-09, 2.766e-09, 1.313e-09, 1.015e-09, 8.363e-10, 7.040e-10, 6.404e-10, 6.264e-10, 5.661e-10, 1.538e-10, 1.500e-10, 1.395e-10, 1.476e-10, 1.503e-10, 2.256e-10, 4.244e-10],
    'PAR': [1.709e-07, 1.953e-07, 1.698e-07, 1.761e-07, 1.808e-07, 1.865e-07, 1.822e-07, 1.859e-07, 2.412e-07, 2.728e-07, 2.174e-07, 1.243e-07, 9.741e-08, 7.744e-08, 6.931e-08, 5.805e-08, 3.900e-08, 3.317e-08, 2.956e-08, 2.306e-08, 2.231e-08, 2.395e-08, 4.284e-08, 9.655e-08],
    'ISOP': [2.412e-10, 2.814e-10, 3.147e-10, 4.358e-10, 5.907e-10, 6.766e-10, 6.594e-10, 5.879e-10, 5.435e-10, 6.402e-10, 5.097e-10, 9.990e-11, 7.691e-11, 5.939e-11, 5.198e-11, 4.498e-11, 3.358e-11, 2.946e-11, 2.728e-11, 2.183e-11, 1.953e-11, 1.890e-11, 2.948e-11, 1.635e-10],
    'CH3OH': [2.368e-10, 6.107e-10, 6.890e-10, 6.890e-10, 6.890e-10, 6.889e-10, 6.886e-10, 6.890e-10, 6.890e-10, 5.414e-10, 3.701e-10, 2.554e-10, 1.423e-10, 6.699e-11, 2.912e-11, 2.877e-11, 2.825e-11, 2.056e-12, 2.056e-12, 2.056e-12, 2.435e-12, 2.435e-12, 4.030e-11, 1.168e-10],
    'ANOL': [5.304e-09, 7.960e-09, 7.649e-09, 7.649e-09, 7.432e-09, 7.428e-09, 7.431e-09, 7.434e-09, 7.434e-09, 6.979e-09, 5.666e-09, 4.361e-09, 4.148e-09, 3.289e-09, 2.858e-09, 2.856e-09, 1.127e-09, 9.615e-10, 9.616e-10, 9.616e-10, 9.654e-10, 9.654e-10, 1.397e-09, 2.264e-09],
}
GAS_EMIT_SCALE = 0.5          # scenario 'rate' scale (gas_emit.dat)
EMIT_HOURS = 12.0             # emissions 06:00-18:00 (published schedule)

# initial gas mixing ratios [ppb] (gas_init.dat, nonzero entries)
GAS_INIT = {'NO': 0.1, 'NO2': 1.0, 'HNO3': 1.0, 'O3': 50.0, 'H2O2': 1.1,
            'CO': 80.0, 'SO2': 0.8, 'NH3': 0.5, 'HCl': 0.7, 'CH4': 2200.0,
            'C2H6': 1.0, 'HCHO': 1.2, 'CH3OH': 0.12, 'CH3OOH': 0.5,
            'ALD2': 1.0, 'PAR': 2.0, 'AONE': 1.0, 'ETH': 0.2,
            'OLET': 0.023, 'OLEI': 0.00031, 'TOL': 0.1, 'XYL': 0.1,
            'ONIT': 0.1, 'PAN': 0.8, 'RCOOH': 0.2, 'ROOH': 0.025,
            'ISOP': 0.5}
GAS_BACK = dict(GAS_INIT, CO=210.0)           # gas_back.dat differs in CO

DILUTION_RATE = 1.5e-5                        # [s^-1] aero_back/gas_back.dat

# initial + background aerosol (remote continental, S&P p.430): mass fracs
INIT_MASS_FRAC = {"OC": 1.375, "SO4": 1.0, "NH4": 0.375}
INIT_MODES = ((3.2e9, 2.0e-8, 10 ** 0.161), (2.9e9, 1.16e-7, 10 ** 0.217))
BACK_MODES = ((1.8e9, 2.0e-8, 10 ** 0.161), (1.5e9, 1.16e-7, 10 ** 0.217))

# aerosol emissions: (#/m^2/s, gmd, gsd, mass fracs, name)
AERO_EMIT = (
    (9.0e6, 8.64e-8, 10 ** 0.28, {"OC": 1.0}, "cooking"),
    (1.6e8, 5.0e-8, 10 ** 0.24, {"OC": 0.3, "BC": 0.7}, "diesel"),
    (5.0e7, 5.0e-8, 10 ** 0.24, {"OC": 0.8, "BC": 0.2}, "gasoline"),
)


def mixing_height(t):
    """[m] 290 at 06:00, growing to 1400 by noon, residual overnight."""
    h = t / 3600.0
    if h <= 2.0:
        return 290.0
    if h <= 6.0:
        return 290.0 + (1400.0 - 290.0) * (h - 2.0) / 4.0
    return 1400.0


def temperature(t):
    """[K] diurnal cycle from 06:00 LST (peak mid-afternoon)."""
    h = t / 3600.0
    if h <= 14.0:                      # 06:00 -> 20:00 warm branch
        return 290.0 + 7.0 * math.sin(math.pi * h / 14.0) ** 1.5
    return 290.0 - 2.0 * (h - 14.0) / 10.0


_E_H2O = 0.85 * 610.78 * math.exp(17.27 * (290.0 - 273.15) / (290.0 - 35.85))


def rel_humid(t):
    """RH from a FIXED water vapor partial pressure (85% at the 290 K
    morning start), swinging down as the afternoon warms — the parcel
    conserves water vapor as in the published scenario."""
    T = temperature(t)
    esat = 610.78 * math.exp(17.27 * (T - 273.15) / (T - 35.85))
    return min(0.95, _E_H2O / esat)


def cos_zenith(t, lat_deg=34.0, decl_deg=15.0):
    """Start 06:00 LST; summer declination (the published episode is a
    Los Angeles summer day)."""
    lst = 6.0 + t / 3600.0
    phi, dec = math.radians(lat_deg), math.radians(decl_deg)
    h = math.radians(15.0 * (lst % 24.0 - 12.0))
    return max(0.0, math.sin(phi) * math.sin(dec)
               + math.cos(phi) * math.cos(dec) * math.cos(h))


def _vol_frac(ad, mass_frac):
    vf = np.zeros(ad.n_spec)
    for name, mf in mass_frac.items():
        vf[ad.spec_by_name(name)] = mf / float(ad.density[ad.spec_by_name(name)])
    return vf / vf.sum()


def build_urban_plume(P=2048, n_ideal=1024, seed=0, device="cuda"):
    """-> (aero0, gas0, scn, benv, ad, gd, mech), ready for
    ``box_model.run_box``, on ``device``.  ``n_ideal`` is the rebalance
    target the caller passes to ``run_box`` (its default, P // 2, is the
    same)."""
    from ..entry import require_device
    from ..models.partmc.aero_data import make_aero_data
    from ..models.partmc.aero_state import fill_fresh
    from ..models.partmc.box_model import BoxEnv
    from ..models.partmc.cbmz import build_mechanism
    from ..models.partmc.dist import concat_dists, make_mode, sample_particles
    from ..models.partmc.gas_data import make_gas_data_cbmz
    from ..models.partmc.scenario import Scenario
    from ..utils import rng
    from ..utils.tree import tree_map

    require_device(device)
    ad = make_aero_data(device=device)
    gd = make_gas_data_cbmz(device=device)
    mech = build_mechanism(device=device)
    vf_bg = _vol_frac(ad, INIT_MASS_FRAC)
    modes = lambda table: concat_dists([make_mode(nc, gmd, gsd, vf_bg, source=0, w_class=0,
                                                  device=device)
                                        for nc, gmd, gsd in table])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    # initial population: the bimodal remote-continental dist, source 0
    vol, num, src, wcl = sample_particles(rng.key(seed), modes(INIT_MODES), ad, P // 2,
                                          1.0, (1, 1, 1))
    aero0 = fill_fresh(ad, P, vol, num, src, wcl)

    # emission dist series: per-m2 fluxes / H(t), hourly slabs; the modes
    # carry their own source id and weight class (1..3)
    T = 25
    times = np.arange(T) * 3600.0
    emit_d = concat_dists([make_mode(flux, gmd, gsd, _vol_frac(ad, mf), source=m + 1,
                                     w_class=m + 1, device=device)
                           for m, (flux, gmd, gsd, mf, _name) in enumerate(AERO_EMIT)])
    nc_t = np.zeros((T, emit_d.n_mode), np.float32)
    nc0 = emit_d.num_conc.cpu().numpy()
    for ti in range(T):
        on = 1.0 if times[ti] < EMIT_HOURS * 3600.0 else 0.0
        nc_t[ti] = nc0 * on / mixing_height(times[ti])
    emit_ts = tree_map(lambda a: a.expand(T, *a.shape), emit_d)
    emit_ts = dataclasses.replace(emit_ts, num_conc=f32(nc_t))

    # gas emission rates [T, G] in ppb/s: flux / (H * n_air) * 1e9 * scale
    g_rate = np.zeros((T, gd.n_spec), np.float32)
    for name, series in GAS_EMIT.items():
        gi = gd.spec_by_name(name)
        for ti in range(T):
            if times[ti] >= EMIT_HOURS * 3600.0:
                continue
            flux = series[min(ti, len(series) - 1)] * GAS_EMIT_SCALE
            n_air = 1.0e5 / (8.314 * temperature(times[ti]))     # mol/m3
            g_rate[ti, gi] = flux / mixing_height(times[ti]) / n_air * 1e9

    # dilution: background exchange + entrainment (dH/dt)/H while growing
    lam = np.full(T, DILUTION_RATE, np.float32)
    for ti in range(T - 1):
        dH = mixing_height(times[ti + 1]) - mixing_height(times[ti])
        if dH > 0:
            lam[ti] += dH / 3600.0 / mixing_height(times[ti])

    back_gas = np.zeros(gd.n_spec, np.float32)
    for name, v in GAS_BACK.items():
        back_gas[gd.spec_by_name(name)] = v
    scn = Scenario(emit_times=f32(times), emit_dist=emit_ts, gas_emit_rate=f32(g_rate),
                   dilution_rate=f32(lam), back_dist=modes(BACK_MODES),
                   back_gas=f32(back_gas))

    gas0 = np.zeros((1, 1, 1, gd.n_spec), np.float32)
    for name, v in GAS_INIT.items():
        gas0[..., gd.spec_by_name(name)] = v

    benv = BoxEnv(temp=temperature, rel_humid=rel_humid, pressure=lambda t: 1.0e5,
                  height=mixing_height, cosz=cos_zenith)
    return aero0, f32(gas0), scn, benv, ad, gd, mech


def hourly_row(t, aero, gas, diag, ad, gd) -> dict:
    """The trajectory values of the parcel at time t [s]: gases [ppb],
    total number [m-3], computational particles, chi, PM2.5 and particulate
    NO3/NH4 [ug m-3] (1800 kg m-3 for both)."""
    gi = lambda n: float(gas[0, 0, 0, gd.spec_by_name(n)])
    mass = lambda n: float((aero.vol[0, 0, 0, ad.spec_by_name(n)]
                            * aero.num[0, 0, 0]).sum()) * 1800.0 * 1e9
    return dict(t_h=t / 3600.0, O3=gi("O3"), NO=gi("NO"), NO2=gi("NO2"), HNO3=gi("HNO3"),
                NH3=gi("NH3"), N2O5=gi("N2O5"), SO2=gi("SO2"),
                N_tot=float(aero.total_num()[0, 0, 0]), n_comp=int(aero.n_alive()[0, 0, 0]),
                chi=float(diag.chi[0, 0, 0]), pm25=float(diag.pm25[0, 0, 0]) * 1e9,
                no3_ug=mass("NO3"), nh4_ug=mass("NH4"))


def main(argv=None):
    """Run the scenario and print hourly trajectories."""
    from ..models.partmc.bin_grid import make_bin_grid
    from ..models.partmc.box_model import run_box
    from ..models.partmc.diagnostics import process

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--hours", type=float, default=24.0)
    ap.add_argument("--particles", type=int, default=2048, help="capacity P")
    ap.add_argument("--dt", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    aero, gas, scn, benv, ad, gd, mech = build_urban_plume(
        args.particles, args.particles // 2, args.seed, device=args.device)
    bg = make_bin_grid(60, 1e-9, 1e-5, device=args.device)
    traj = []

    def observe(t, a, g, env):
        if int(round(t)) % 3600 != 0:
            return
        row = hourly_row(t, a, g, process(a, ad, env, bg, advanced=False), ad, gd)
        traj.append(row)
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in row.items()}))

    run_box(aero, gas, scn, benv, ad, gd, mech, t_end=args.hours * 3600.0, dt=args.dt,
            seed=args.seed, observer=observe)
    return traj


if __name__ == "__main__":
    main()
