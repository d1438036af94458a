"""PartMC spec-file dialect: .spec scenario files and the .dat leaf formats.

The port's own copy of ``wrf_partmc_tpu/utils/spec_file.py``, whose dists
are the port's :class:`AeroDist` (torch tensors on ``aero_data``'s
device).  The input dialect is the one the reference reads
(``partmc/src/spec_file.F90`` readers driven from ``wrf_pmc_init.F90``):

* scenario ``.spec`` -- whitespace key/value(s) lines, ``#`` comments, in a
  per-height variant with a leading ``z`` row and one file column per
  height (``WRFV3/test/em_scm_xy/test.spec``) and a flat key/value variant;
* aerosol mode ``.dat`` -- blocks of ``mode_name / mass_frac <file> /
  mode_type / num_conc / geom_mean_diam / log10_geom_std_dev``
  (log_normal) or ``diam`` / ``num_conc`` rows (sampled);
* composition ``.dat`` -- ``SPECIES  mass_fraction`` lines;
* gas init ``.dat`` -- ``SPECIES  ppb`` lines;
* gas emission ``.dat`` -- ``time``/``rate`` rows and per-species rate rows
  [mol m-2 s-1];
* aerosol emission ``.dat`` -- ``time``/``rate``/``dist`` rows, each dist a
  per-time aero-dist file.

Parsing is host-side setup work in numpy.
"""

from __future__ import annotations

import os

import numpy as np


def parse_spec_lines(text: str):
    """[(key, [tokens])] with comments stripped, order preserved."""
    out = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        out.append((toks[0], toks[1:]))
    return out


def read_spec(path: str) -> dict:
    """.spec -> {key: [values]} (later duplicate keys win, as the Fortran
    sequential reader effectively does for re-specified entries)."""
    with open(path) as f:
        return {k: v for k, v in parse_spec_lines(f.read())}


def read_name_value_dat(path: str) -> dict:
    """``NAME value`` lines -> {name: float} (gas_init / mass_frac files)."""
    with open(path) as f:
        pairs = parse_spec_lines(f.read())
    return {k: float(v[0]) for k, v in pairs if v}


def mass_frac_to_vol_frac(mass_frac: dict, aero_data) -> np.ndarray:
    """[S] volume fractions from a {species: mass fraction} mapping
    (divide by density, renormalize — aero_mode_t's mass->vol conversion)."""
    rho = aero_data.density.cpu().numpy()
    vf = np.zeros(aero_data.n_spec)
    for name, mf in mass_frac.items():
        if name in aero_data.names:
            i = aero_data.names.index(name)
            vf[i] = mf / rho[i]
    s = vf.sum()
    if s <= 0:
        raise ValueError(f"no known species in mass_frac {list(mass_frac)}")
    return vf / s


def read_aero_dist_dat(path: str, aero_data, source=0, w_class=0):
    """Aerosol mode file -> AeroDist (stacked modes; log_normal and sampled
    mode types — AERO_MODE_TYPE_SAMPLED becomes per-bin narrow modes)."""
    from ..models.partmc.dist import concat_dists, from_sampled, make_mode

    dev = aero_data.density.device
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        pairs = parse_spec_lines(f.read())
    # split into blocks at each mode_name
    blocks, cur = [], None
    for k, v in pairs:
        if k == "mode_name":
            cur = {"mode_name": v[0]}
            blocks.append(cur)
        elif cur is not None:
            cur[k] = v
    dists = []
    for b in blocks:
        mf = read_name_value_dat(os.path.join(base, b["mass_frac"][0]))
        vf = mass_frac_to_vol_frac(mf, aero_data)
        mtype = b.get("mode_type", ["log_normal"])[0]
        if mtype == "log_normal":
            gsd = 10.0 ** float(b["log10_geom_std_dev"][0]) \
                if "log10_geom_std_dev" in b else float(b["geom_std_dev"][0])
            dists.append(make_mode(float(b["num_conc"][0]),
                                   float(b["geom_mean_diam"][0]), gsd, vf,
                                   source=source, w_class=w_class, device=dev))
        elif mtype == "sampled":
            edges = np.asarray([float(x) for x in b["diam"]])
            nc = np.asarray([float(x) for x in b["num_conc"]])
            dists.append(from_sampled(edges, nc, vf, source=source,
                                      w_class=w_class, device=dev))
        else:
            raise ValueError(f"unknown mode_type {mtype!r} in {path}")
    if not dists:
        raise ValueError(f"no modes in {path}")
    return concat_dists(dists) if len(dists) > 1 else dists[0]


def read_gas_init_dat(path: str, gas_data) -> np.ndarray:
    """[G] initial mix ratios [ppb] by species name (unknown names skipped,
    as the reference warns-and-skips)."""
    vals = read_name_value_dat(path)
    out = np.zeros(gas_data.n_spec)
    for name, v in vals.items():
        if name in gas_data.names:
            out[gas_data.names.index(name)] = v
    return out


def read_gas_emit_dat(path: str, gas_data):
    """-> (times [T], rates [T], emit [T, G] mol m-2 s-1)."""
    with open(path) as f:
        pairs = parse_spec_lines(f.read())
    d = {k: v for k, v in pairs}
    times = np.asarray([float(x) for x in d.pop("time")])
    rates = np.asarray([float(x) for x in d.pop("rate")])
    emit = np.zeros((len(times), gas_data.n_spec))
    for name, vals in d.items():
        if name in gas_data.names:
            emit[:, gas_data.names.index(name)] = [float(x) for x in vals]
    return times, rates, emit


def read_aero_emit_dat(path: str, aero_data, source=0, w_class=0):
    """-> (times [T], rates [T], [AeroDist] per time)."""
    base = os.path.dirname(os.path.abspath(path))
    d = read_spec(path)
    times = np.asarray([float(x) for x in d["time"]])
    rates = np.asarray([float(x) for x in d["rate"]])
    dists = [read_aero_dist_dat(os.path.join(base, p), aero_data,
                                source=source, w_class=w_class)
             for p in d["dist"]]
    return times, rates, dists


def load_scenario_spec(path: str):
    """Scenario .spec -> normalized description.

    Returns a dict with ``z`` ([L] heights, [0.0] for the flat variant) and
    per-level file-path lists for the keys gas_data / gas_init / aero_data /
    aero_init / gas_emission / aero_emission (absent keys -> None), all
    resolved relative to the spec file's directory."""
    base = os.path.dirname(os.path.abspath(path))
    d = read_spec(path)
    alias = {"aerosol_data": "aero_data", "aerosol_init": "aero_init"}
    d = {alias.get(k, k): v for k, v in d.items()}
    z = [float(x) for x in d.pop("z")] if "z" in d else [0.0]
    out = {"z": np.asarray(z)}
    for key in ("gas_data", "gas_init", "aero_data", "aero_init",
                "gas_emission", "aero_emission"):
        if key in d:
            paths = [os.path.join(base, p) for p in d[key]]
            if len(paths) == 1 and len(z) > 1:
                paths = paths * len(z)
            if len(paths) != len(z):
                raise ValueError(f"{key}: {len(paths)} files for {len(z)} z")
            out[key] = paths
        else:
            out[key] = None
    # pass through any remaining simple keys (nz, grid_name, ...)
    for k, v in d.items():
        if k not in out:
            out[k] = v[0] if len(v) == 1 else v
    return out
