"""Time-series forcing: emissions and background dilution.

Port of ``wrf_partmc_tpu/models/partmc/scenario.py`` (constant scenario,
gas update, aerosol emission + dilution update).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ...utils import rng
from ...utils.tree import tree_map
from .aero_data import AeroData
from .aero_state import AeroState, add_particles
from .dist import AeroDist, dist_number_conc, sample_particles


@dataclass(frozen=True)
class Scenario:
    emit_times: torch.Tensor     # [T] s
    emit_dist: AeroDist          # arrays [T, M, ...], rates in # m-3 s-1
    gas_emit_rate: torch.Tensor  # [T, G] ppb s-1
    dilution_rate: torch.Tensor  # [] or [T] s-1
    back_dist: AeroDist          # [M2, ...] background aerosol
    back_gas: torch.Tensor       # [G] ppb


def constant_scenario(aero_data: AeroData, n_gas: int, emit_dist: AeroDist,
                      dilution_rate=0.0) -> Scenario:
    """A time-constant scenario (one time slab), zero gas emission and an
    empty background."""
    dev = emit_dist.num_conc.device
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return Scenario(emit_times=f32(1),
                    emit_dist=tree_map(lambda x: x[None], emit_dist),
                    gas_emit_rate=f32(1, n_gas),
                    dilution_rate=torch.tensor(dilution_rate, dtype=torch.float32,
                                               device=dev),
                    back_dist=tree_map(torch.zeros_like, emit_dist),
                    back_gas=f32(n_gas))


def at_clamped(a, i):
    """``a[i]`` with ``i`` clamped to ``a``'s first axis, as a JAX gather
    indexes: the mode-only ``source``/``w_class`` of a dist read from a file
    are indexed by the time slab like the per-time arrays, so past their
    mode count they give the last mode's value."""
    return a[torch.clamp(torch.as_tensor(i), max=a.shape[0] - 1)]


def _time_index(times, t):
    tt = torch.tensor([t], dtype=torch.float32, device=times.device)
    i = torch.searchsorted(times, tt, right=True)[0] - 1
    return torch.clamp(i, 0, times.shape[0] - 1)


def _time_weight(times, t):
    """(i, i+1, w): linear interpolation weights, clamped at the ends."""
    i = _time_index(times, t)
    j = torch.clamp(i + 1, max=times.shape[0] - 1)
    span = torch.clamp(times[j] - times[i], min=1e-30)
    w = torch.clamp((t - times[i]) / span, 0.0, 1.0)
    return i, j, torch.where(j == i, 0.0, w)


def dist_at_time(scn: Scenario, t) -> AeroDist:
    """Emission dist at time t: mode intensities interpolated in time, shape
    parameters from the lower slab."""
    i, j, w = _time_weight(scn.emit_times, t)
    d_i = tree_map(lambda a: at_clamped(a, i), scn.emit_dist)
    nc_j = scn.emit_dist.num_conc[j]
    return dataclasses.replace(d_i, num_conc=(1.0 - w) * d_i.num_conc + w * nc_j)


def _dilution(scn: Scenario, i):
    return scn.dilution_rate if scn.dilution_rate.dim() == 0 else scn.dilution_rate[i]


def update_gas_state(scn: Scenario, gas, t, dt):
    """Gas emission + first-order dilution toward background."""
    i, j, w = _time_weight(scn.emit_times, t)
    rate = (1.0 - w) * scn.gas_emit_rate[i] + w * scn.gas_emit_rate[j]
    lam = _dilution(scn, i)
    g = gas + dt * rate
    return g + (1.0 - torch.exp(-lam * dt)) * (scn.back_gas - g)


def update_aero_state(scn: Scenario, state: AeroState, aero_data: AeroData,
                      t, dt, key, n_emit_slots: int, cell_volume,
                      block=None) -> AeroState:
    """Aerosol emission + dilution over dt: (1) per-particle survival of the
    dilution, (2) background in-mixing sample, (3) emission sample.  With
    ``block`` (``rng.Block``), ``state`` is a rank's block and every draw
    the block's slice of the global draw."""
    cell_shape = state.cell_shape
    k_dil, k_back, k_emit = rng.split(key, 3)
    i = _time_index(scn.emit_times, t)
    lam = _dilution(scn, i)
    p_out = 1.0 - torch.exp(-lam * dt)

    u = rng.uniform(k_dil, state.num.shape, state.num.device, block=block)
    keep = (u >= p_out) & state.alive
    state = dataclasses.replace(
        state, num=torch.where(keep, state.num, 0.0),
        vol=torch.where(keep[..., None, :], state.vol, 0.0))

    def inject(state, dist, added_number, key):
        vol, num, src, wcl = sample_particles(key, dist, aero_data,
                                              n_emit_slots, 1.0, cell_shape, block)
        tot = dist_number_conc(dist)
        # the reference's max(tot, 1e-300) is max(tot, 0) in f32: an empty
        # dist gives 0/0 = NaN multiplicities, which add_particles turns
        # into dead slots
        scale = (added_number / torch.clamp(tot, min=0.0)).to(torch.float32)
        return add_particles(state, vol, num * scale[..., None], src, wcl, time=t)

    n_back_add = dist_number_conc(scn.back_dist) * p_out * cell_volume
    state = inject(state, scn.back_dist, n_back_add, k_back)
    edist = dist_at_time(scn, t)
    e_add = dist_number_conc(edist) * dt * cell_volume
    return inject(state, edist, e_add, k_emit)
