"""History, particle-state and restart files.

Port of ``wrf_partmc_tpu/utils/io.py``, with the same NetCDF schemas
(classic 64-bit-offset files through scipy, whole-domain arrays, one file
per stream and write): the WRF-style history, the per-particle removal
records, the particle-state file that doubles as the portable restart, and
the dycore/physics sibling of the NetCDF restart.  The NetCDF files are
read by name, so a file written by either package reads into the other.

The npz restart is exact and same-shape only, like a WRF binary restart.
Its entries are named by the state's field paths (``state__dyn__u``,
``state__removals__coag``, ...) with the step counter and the land-surface
type beside them; the JAX package orders its npz leaves by its own pytree,
so npz files of the two packages do not mix (reading one into the other
raises).

Tensors on the card are copied to the host to be written; read-back
states land on the template's device.  With ``writer`` (a
:class:`~.quilt.QuiltWriter`) a file is encoded in memory and written by
the native thread pool.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np
import torch
from scipy.io import netcdf_file

from ..models.coupled.driver import CoupledState
from .tree import tensor_leaves, with_leaves


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _var(f, name) -> np.ndarray:
    """A NetCDF variable's values in native byte order (the files hold
    big-endian values, which torch does not take)."""
    a = np.array(f.variables[name][:])
    return a.astype(a.dtype.newbyteorder("="))


class _NcOut:
    """A NetCDF file written straight to ``path`` (writer=None) or encoded
    in memory and handed to the quilt pool."""

    def __init__(self, path, writer=None):
        self.path = path
        self.writer = writer
        self.buf = io.BytesIO() if writer is not None else None
        self.f = netcdf_file(self.buf if writer is not None else path, "w", version=2)

    def close(self):
        self.f.flush()
        if self.writer is not None:
            self.writer.submit_bytes(self.path, self.buf.getvalue())
        self.f.close()


def write_history(path: str, cs: CoupledState, grid, cfg, diag=None,
                  writer=None, trans_diag=None) -> None:
    """WRF-style history file: prognostic fields, the removal counters when
    recorded, the transport saturation counters ``trans_diag``
    (host-accumulated overflow_class / overflow_free / movers) as scalars,
    and the gridded aerosol diagnostics ``diag`` when given."""
    out = _NcOut(path, writer)
    f = out.f
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    f.createDimension("z", nz)
    f.createDimension("z_stag", nz + 1)
    f.createDimension("y", ny)
    f.createDimension("x", nx)
    f.createDimension("class", cfg.n_class)
    f.createDimension("moist", cs.dyn.moist.shape[0])
    f.createDimension("gas", cs.gas.shape[-1])

    def var(name, dims, data):
        v = f.createVariable(name, "f", dims)
        v[:] = _np(data).astype(np.float32, copy=False)

    var("U", ("z", "y", "x"), cs.dyn.u)
    var("V", ("z", "y", "x"), cs.dyn.v)
    var("W", ("z_stag", "y", "x"), cs.dyn.w)
    var("T", ("z", "y", "x"), cs.dyn.theta_p)        # theta perturbation (WRF 'T')
    var("P", ("z", "y", "x"), cs.dyn.p_p)
    var("QVAPOR", ("z", "y", "x"), cs.dyn.moist[0])
    var("NUM_CONC", ("class", "z", "y", "x"), cs.dyn.num_conc)
    var("ZH", ("z",), grid.z_half)
    if cs.removals is not None:
        for cause, arr in sorted(cs.removals.items()):
            var(f"removed_num_{cause}", ("z", "y", "x"), arr)
    if trans_diag is not None:
        for name, val in sorted(trans_diag.items()):
            f.createVariable(f"trans_{name}", "f", ())[...] = float(_np(val))
    if diag is not None:
        f.createDimension("bin", diag.num_dist.shape[-1])
        f.createDimension("spec", diag.spec_mass.shape[-1])
        f.createDimension("ccn_s", diag.ccn.shape[-1])
        var("num_dist", ("z", "y", "x", "bin"), diag.num_dist)
        var("mass_dist", ("z", "y", "x", "bin"), diag.mass_dist)
        var("spec_mass", ("z", "y", "x", "spec"), diag.spec_mass)
        for name in ("chi", "d_alpha", "d_gamma", "chi_sub"):
            var(name, ("z", "y", "x"), getattr(diag, name))
        var("ccn", ("z", "y", "x", "ccn_s"), diag.ccn)
        for name in ("pm1", "pm25", "pm10", "b_scat", "b_abs", "b_scat_mix", "b_abs_mix"):
            var(name, ("z", "y", "x"), getattr(diag, name))
        var("ccn_mix", ("z", "y", "x", "ccn_s"), diag.ccn_mix)
    out.close()


AERO_REMOVED_COLUMNS = ("step", "cell", "removed_id", "other_id")


def write_aero_removed(path: str, rows, writer=None) -> None:
    """Per-particle removal records (the reference's aero_removed output,
    action=coag): each row is (step, flat cell index, removed particle id,
    surviving partner id).  ``rows``: [n_i, 4] int arrays gathered since the
    last history alarm."""
    all_rows = np.concatenate(rows, axis=0) if rows else np.zeros((0, 4), int)
    n = all_rows.shape[0]
    out = _NcOut(path, writer)
    f = out.f
    f.createDimension("event", max(n, 1))
    pad = np.full((max(n, 1), 4), -1, np.int32)
    pad[:n] = all_rows
    for j, name in enumerate(AERO_REMOVED_COLUMNS):
        f.createVariable(f"aero_removed_{name}", "i", ("event",))[:] = pad[:, j]
    f.n_events = np.int32(n)
    f.aero_removed_action = b"coag"
    out.close()


def _land_type(cs: CoupledState) -> str:
    return "" if cs.land is None else type(cs.land).__name__


def write_restart(path: str, cs: CoupledState, writer=None) -> None:
    """Exact coupled-model restart (dycore, particles with ``next_id``,
    gases, land, MYJ q2, removal counters, step) as one compressed npz,
    named by field path."""
    arrs = {name: _np(t) for name, t in tensor_leaves(cs, "state").items()}
    arrs["step"] = np.asarray(cs.step, np.int64)
    arrs["land_type"] = np.asarray(_land_type(cs))
    if writer is not None:
        writer.submit_npz(path, lambda buf: np.savez_compressed(buf, **arrs))
    else:
        np.savez_compressed(path, **arrs)


def read_restart(path: str, template: CoupledState) -> CoupledState:
    """A :func:`write_restart` file into a state shaped like ``template``
    (configuration and shapes must match; every entry must be there)."""
    with np.load(path) as data:
        names = set(data.files)
        leaves = tensor_leaves(template, "state")
        if not {"step", "land_type"} <= names:
            raise ValueError(f"{path}: not a restart of this package's state; npz "
                             "restarts of the JAX package do not mix")
        if str(data["land_type"]) != _land_type(template):
            raise ValueError(f"{path}: land_type {str(data['land_type'])!r} != "
                             f"{_land_type(template)!r}")
        missing = set(leaves) - names
        extra = names - set(leaves) - {"step", "land_type"}
        if missing or extra:
            raise ValueError(f"{path}: entries missing {sorted(missing)[:4]}, entries "
                             f"the template lacks {sorted(extra)[:4]}")
        new = {}
        for name, leaf in leaves.items():
            arr = data[name]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"restart {name} shape {arr.shape} != {tuple(leaf.shape)}")
            new[name] = torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
        step = int(data["step"])
    return dataclasses.replace(with_leaves(template, "state", new), step=step)


def write_particle_netcdf(path: str, cs: CoupledState, aero_data, grid,
                          with_optics: bool = False, writer=None) -> None:
    """Particle-state NetCDF: per-particle species volumes, multiplicities,
    ids, sources, weight classes, creation times, source components and
    hysteresis legs, with gas mixing ratios and ``next_id``.
    ``with_optics`` adds per-particle optical cross-sections, asymmetry and
    volume-mixed refractive index at the four bands, from the Mie table at
    write time."""
    out = _NcOut(path, writer)
    f = out.f
    a = cs.aero
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    for name, n in (("z", nz), ("y", ny), ("x", nx), ("part", a.capacity),
                    ("spec", a.vol.shape[-2]), ("gas", cs.gas.shape[-1]),
                    ("src_comp", a.n_src_comp)):
        f.createDimension(name, n)

    def var(name, dims, data, typ="f"):
        f.createVariable(name, typ, dims)[:] = _np(data)

    cell = ("z", "y", "x")
    var("aero_particle_vol", cell + ("spec", "part"), a.vol)
    var("aero_num", cell + ("part",), a.num)
    var("aero_id", cell + ("part",), a.pid, "i")
    var("aero_source", cell + ("part",), a.source, "i")
    var("aero_weight_class", cell + ("part",), a.w_class, "i")
    var("aero_create_time", cell + ("part",), a.t_create)
    var("aero_comp_source", cell + ("src_comp", "part"), a.src_id, "i")
    var("aero_comp_vol", cell + ("src_comp", "part"), a.src_vol)
    var("aero_water_hyst_leg", cell + ("part",), a.hyst_leg, "i")
    var("next_id", cell, a.next_id, "i")
    var("gas_mixrat", cell + ("gas",), cs.gas)
    if with_optics:
        from ..models.partmc.optics import (WAVELENGTHS, particle_refractive_index,
                                            per_particle_optics)

        f.createDimension("band", len(WAVELENGTHS))
        c_sca, c_abs, g = per_particle_optics(a, aero_data)
        ri_n, ri_k = particle_refractive_index(a, aero_data)
        var("aero_scatter_xsec", ("band",) + cell + ("part",), c_sca)
        var("aero_absorb_xsec", ("band",) + cell + ("part",), c_abs)
        var("aero_asymmetry", ("band",) + cell + ("part",), g)
        var("aero_refract_real", cell + ("part",), ri_n)
        var("aero_refract_imag", cell + ("part",), ri_k)
        f.optics_wavelengths_m = ",".join(str(w) for w in WAVELENGTHS).encode()
    f.aero_species = ",".join(aero_data.names).encode()
    out.close()


def read_particle_netcdf(path: str, template: CoupledState, aero_data=None):
    """Particle-state NetCDF -> (AeroState, gas) shaped like ``template``.

    The file's particle capacity may differ from the template's: a larger
    template pads with dead slots; a smaller one keeps each cell's largest
    multiplicities and rescales them so the represented number is
    conserved.  With ``aero_data`` species are matched by name against the
    file's ``aero_species`` (a missing species reads as zero volume)."""
    f = netcdf_file(path, "r", mmap=False)
    g = lambda n: _var(f, n)
    vol = g("aero_particle_vol")                   # [z, y, x, S, Pf]
    num = g("aero_num")
    pid = g("aero_id")
    source = g("aero_source")
    w_class = g("aero_weight_class")
    t_create = g("aero_create_time")
    src_id = g("aero_comp_source")
    src_vol = g("aero_comp_vol")
    hyst_leg = (g("aero_water_hyst_leg") if "aero_water_hyst_leg" in f.variables
                else np.ones(num.shape, np.int32))   # older files: upper leg
    next_id = g("next_id")
    gas = g("gas_mixrat")
    names_file = getattr(f, "aero_species", b"").decode().split(",")
    f.close()

    if aero_data is not None and names_file and names_file[0]:
        vol_t = np.zeros(vol.shape[:-2] + (aero_data.n_spec, vol.shape[-1]), vol.dtype)
        for i_f, name in enumerate(names_file):
            if name in aero_data.names:
                vol_t[..., aero_data.names.index(name), :] = vol[..., i_f, :]
        vol = vol_t

    a = template.aero
    P_t = a.capacity
    P_f = num.shape[-1]
    if P_f != P_t:
        take = np.argsort(-num, axis=-1)[..., :min(P_f, P_t)]   # largest first
        tot = num.sum(axis=-1)
        take_k = lambda arr: np.take_along_axis(arr, take[..., None, :], axis=-1)
        take_p = lambda arr: np.take_along_axis(arr, take, axis=-1)
        vol, src_id, src_vol = take_k(vol), take_k(src_id), take_k(src_vol)
        num, pid, source = take_p(num), take_p(pid), take_p(source)
        w_class, t_create, hyst_leg = take_p(w_class), take_p(t_create), take_p(hyst_leg)
        if P_f > P_t:
            kept = num.sum(axis=-1)
            scale = np.divide(tot, kept, out=np.ones_like(tot), where=kept > 0)
            num = num * scale[..., None]
        else:
            def zpad(arr, fill=0):
                return np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, P_t - P_f)],
                              constant_values=fill)

            vol, num, pid = zpad(vol), zpad(num), zpad(pid)
            source, w_class, t_create = zpad(source), zpad(w_class), zpad(t_create)
            src_id, src_vol = zpad(src_id, -1), zpad(src_vol)
            hyst_leg = zpad(hyst_leg, 1)

    K_t = a.n_src_comp
    K_f = src_id.shape[-2]
    if K_f > K_t:
        src_id, src_vol = src_id[..., :K_t, :], src_vol[..., :K_t, :]
    elif K_f < K_t:
        padk = [(0, 0)] * (src_id.ndim - 2) + [(0, K_t - K_f), (0, 0)]
        src_id = np.pad(src_id, padk, constant_values=-1)
        src_vol = np.pad(src_vol, padk)

    dev = a.num.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    aero = dataclasses.replace(
        a, vol=f32(vol), num=f32(num), pid=i32(pid), source=i32(source),
        w_class=i32(w_class), t_create=f32(t_create), next_id=i32(next_id),
        src_id=i32(src_id), src_vol=f32(src_vol), hyst_leg=i32(hyst_leg))
    return aero, f32(gas)


DYN_RESTART_FIELDS = ("u", "v", "w", "theta_p", "p_p", "moist", "chem",
                      "num_conc", "tke", "mu", "ph")
_DYN_DIMS = {"moist": ("moist", "z", "y", "x"), "chem": ("gas_adv", "z", "y", "x"),
             "num_conc": ("class", "z", "y", "x"), "w": ("z_stag", "y", "x"),
             "ph": ("z_stag", "y", "x"), "mu": ("y", "x")}
_SOIL = 8                                # padded soil-layer dimension


def write_restart_netcdf(path: str, cs: CoupledState, aero_data, grid,
                         writer=None) -> None:
    """Portable restart: the particle-state file at ``path`` and, in
    ``path + ".dyn"``, the named dycore prognostics, the land-surface state
    (every field of its dataclass, with its type in ``land_type``), the MYJ
    q2, the removal counters and the step.  It reads back across particle
    capacities and across the two packages."""
    write_particle_netcdf(path, cs, aero_data, grid, writer=writer)
    out = _NcOut(path + ".dyn", writer)
    f = out.f
    for name, n in (("z", grid.nz), ("z_stag", grid.nz + 1), ("y", grid.ny),
                    ("x", grid.nx), ("moist", cs.dyn.moist.shape[0]),
                    ("gas_adv", cs.dyn.chem.shape[0]),
                    ("class", cs.dyn.num_conc.shape[0])):
        f.createDimension(name, n)

    def var(name, dims, data):
        f.createVariable(name, "f", dims)[:] = _np(data).astype(np.float32, copy=False)

    for name in DYN_RESTART_FIELDS:
        val = getattr(cs.dyn, name)
        if val is not None:
            var(name, _DYN_DIMS.get(name, ("z", "y", "x")), val)
    if cs.land is not None:
        f.land_type = _land_type(cs).encode()
        f.createDimension("soil", _SOIL)
        for fld in dataclasses.fields(cs.land):
            val = _np(getattr(cs.land, fld.name))
            typ = "i" if val.dtype.kind == "i" else "f"
            if val.ndim == 2:
                f.createVariable(f"land_{fld.name}", typ, ("y", "x"))[:] = val
            else:                                  # [n_layer, ny, nx]
                buf = np.zeros((_SOIL, *val.shape[1:]), val.dtype)
                buf[:val.shape[0]] = val
                f.createVariable(f"land_{fld.name}", typ, ("soil", "y", "x"))[:] = buf
                setattr(f, f"land_{fld.name}_nlayer", np.int32(val.shape[0]))
    if cs.pbl_q2 is not None:
        var("pbl_q2", ("z_stag", "y", "x"), cs.pbl_q2)
    if cs.removals is not None:
        for cause, arr in sorted(cs.removals.items()):
            var(f"removed_num_{cause}", ("z", "y", "x"), arr)
    f.step = int(cs.step)
    out.close()


def read_restart_netcdf(path: str, template: CoupledState, aero_data=None) -> CoupledState:
    """A :func:`write_restart_netcdf` pair into a state shaped like
    ``template`` (the particle capacity may differ).  Raises when the file's
    land-surface type is not the template's."""
    aero, gas = read_particle_netcdf(path, template, aero_data)
    dev = gas.device
    f = netcdf_file(path + ".dyn", "r", mmap=False)
    read = lambda name: torch.as_tensor(_var(f, name)).to(device=dev, dtype=torch.float32)
    file_land = getattr(f, "land_type", b"")
    file_land = file_land.decode() if isinstance(file_land, bytes) else str(file_land)
    if file_land != _land_type(template):
        f.close()
        raise ValueError(f"{path}.dyn: land_type {file_land!r} != the template's "
                         f"{_land_type(template)!r}")
    dyn = dataclasses.replace(template.dyn, **{
        name: read(name) for name in DYN_RESTART_FIELDS
        if name in f.variables and getattr(template.dyn, name) is not None})
    land = template.land
    if land is not None:
        kw = {}
        for fld in dataclasses.fields(land):
            tmpl = getattr(land, fld.name)
            name = f"land_{fld.name}"
            if name not in f.variables and fld.name in ("tsk", "t_deep"):
                name = fld.name                    # older slab files
            if name not in f.variables:
                continue
            raw = _var(f, name)
            if raw.ndim == 3:                      # stored in the padded soil dim
                raw = raw[:int(getattr(f, f"land_{fld.name}_nlayer", tmpl.shape[0]))]
            kw[fld.name] = torch.as_tensor(raw).to(device=dev, dtype=tmpl.dtype)
        land = dataclasses.replace(land, **kw)
    pbl_q2 = template.pbl_q2
    if pbl_q2 is not None and "pbl_q2" in f.variables:
        pbl_q2 = read("pbl_q2")
    removals = template.removals
    if removals is not None:
        removals = {cause: (read(f"removed_num_{cause}")
                            if f"removed_num_{cause}" in f.variables else arr)
                    for cause, arr in removals.items()}
    step = int(getattr(f, "step", 0))
    f.close()
    return dataclasses.replace(template, dyn=dyn, aero=aero, gas=gas, step=step,
                               land=land, pbl_q2=pbl_q2, removals=removals)
