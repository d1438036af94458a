"""Stochastic coagulation (super-droplet all-or-nothing Monte Carlo).

Port of ``coag_step`` and the Brownian kernel of
``wrf_partmc_tpu/models/partmc/coag.py``: each step pairs the alive slots of
every cell through one random permutation, applied to the packed payload by
``gather_rows`` (kernel K3 on CUDA), draws the number of coalescence events
per pair, and merges the pair in place.  With ``return_events`` it also
returns the per-pair removal records (the reference's ``aero_info_array``
with action=coag).
"""

from __future__ import annotations

import dataclasses

import torch

from ... import constants as c
from ...ops.place import gather_rows
from ...utils import rng
from .aero_data import AeroData, vol_to_diam
from .aero_state import _PID_SPLIT, AeroState, pack_payload, unpack_payload
from .env_state import EnvState


def cunningham_slip(diam, mean_free_path):
    kn = 2.0 * mean_free_path / diam
    return 1.0 + kn * (1.257 + 0.4 * torch.exp(-1.1 / kn))


def brownian_kernel(d1, d2, m1, m2, env: EnvState):
    """Fuchs-form Brownian coagulation kernel [m3 s-1]; env fields [cells...]
    get a trailing particle axis."""
    temp = env.temp[..., None]
    mfp = env.air_mean_free_path[..., None]
    kT = c.BOLTZMANN * temp

    def props(d, m):
        cc = cunningham_slip(d, mfp)
        diff = kT * cc / (3.0 * torch.pi * c.AIR_DYN_VISC * d)
        spd = torch.sqrt(8.0 * kT / (torch.pi * torch.clamp(m, min=1e-30)))
        lp = 8.0 * diff / (torch.pi * spd)
        g = ((d + lp) ** 3 - (d * d + lp * lp) ** 1.5) / (3.0 * d * lp) - d
        return diff, spd, g

    D1, c1, g1 = props(d1, m1)
    D2, c2, g2 = props(d2, m2)
    dsum = d1 + d2
    Dsum = D1 + D2
    cbar = torch.sqrt(c1 * c1 + c2 * c2)
    gbar = torch.sqrt(g1 * g1 + g2 * g2)
    denom = dsum / (dsum + 2.0 * gbar) + 8.0 * Dsum / (cbar * dsum)
    return 2.0 * torch.pi * Dsum * dsum / denom


def _merge_components(sml, big, g, did, S: int, K: int):
    """Source-component merge: combine the two K-lists (the big side's
    volumes scaled by the event count), accumulate duplicate sources into
    their first occurrence and keep the top K by attributed volume."""
    sv_s = sml[..., 6 + S:6 + S + K, :].transpose(-1, -2)         # [.., np, K]
    si_s = torch.round(sml[..., 6 + S + K:6 + S + 2 * K, :].transpose(-1, -2)).to(torch.int32)
    sv_b = g[..., :, None] * big[..., 6 + S:6 + S + K, :].transpose(-1, -2)
    si_b = torch.round(big[..., 6 + S + K:6 + S + 2 * K, :].transpose(-1, -2)).to(torch.int32)
    cv = torch.cat([sv_s, sv_b], dim=-1)                          # [.., np, 2K]
    ci = torch.cat([si_s, si_b], dim=-1)
    eq = ci[..., :, None] == ci[..., None, :]                     # [.., 2K, 2K]
    first = torch.argmax(eq.to(torch.uint8), dim=-1)              # first occurrence
    K2 = 2 * K
    cv_m = sum(torch.where(first[..., j:j + 1] == torch.arange(K2, device=cv.device),
                           cv[..., j:j + 1], 0.0) for j in range(K2))
    is_first = first == torch.arange(K2, device=cv.device)
    cv_m = torch.where(is_first & (ci >= 0), cv_m, -1.0)
    # stable: invalid entries tie at key 1.0 and keep their list order
    order = torch.argsort(-cv_m, dim=-1, stable=True)[..., :K]
    sv_out = torch.clamp(torch.gather(cv_m, -1, order), min=0.0)
    si_out = torch.gather(ci, -1, order)
    si_out = torch.where(sv_out > 0.0, si_out, -1)
    sv_out = torch.where(did[..., None], sv_out, sv_s)
    si_out = torch.where(did[..., None], si_out, si_s)
    return sv_out, si_out


def coag_step(state: AeroState, aero_data: AeroData, env: EnvState, dt, key,
              return_events: bool = False):
    """One Monte Carlo coagulation step over every cell at once.

    ``return_events=True`` also returns ``{"removed_id", "other_id"}``,
    each [..., P//2] int32: for each candidate pair, the id of the particle
    whose multiplicity reached zero and of its surviving partner, -1 where
    the pair removed nothing.  The ids come from the payload's two pid
    channels (lo, hi), as the reference reads them."""
    P = state.capacity
    n_pair = P // 2
    cs = state.cell_shape
    S = state.vol.shape[-2]
    K = state.n_src_comp
    C = state.num[..., 0].numel()
    k_perm, k_evt = rng.split(key)

    # random permutation with alive slots first: dead slots all get the key
    # 2.0, so the sort must be stable (jnp.argsort is) to give the same order
    u = rng.uniform(k_perm, state.num.shape, state.num.device)
    perm = torch.argsort(torch.where(state.alive, u, 2.0), dim=-1, stable=True)
    src = torch.cat([perm[..., 0:2 * n_pair:2], perm[..., 1:2 * n_pair:2],
                     perm[..., 2 * n_pair:]], dim=-1)
    rows = gather_rows(pack_payload(state),
                       src.reshape(C, P).to(torch.int32).contiguous())
    rows = rows.reshape(*cs, rows.shape[1], P)
    A = rows[..., :n_pair]
    B = rows[..., n_pair:2 * n_pair]

    def side(r):
        num = r[..., 0, :]
        vol = r[..., 6:6 + S, :]
        pvol = torch.sum(vol, dim=-2)
        mass = torch.sum(vol * aero_data.density[:, None], dim=-2)
        diam = vol_to_diam(torch.clamp(pvol, min=0.0))   # 1e-300 is 0 in f32
        return num, diam, mass

    num_a, d_a, m_a = side(A)
    num_b, d_b, m_b = side(B)

    kk = brownian_kernel(d_a, d_b, m_a, m_b, env)
    n = state.n_alive().to(torch.float32)[..., None]
    pair_scale = n * (n - 1.0) / (2.0 * torch.clamp(torch.floor(n / 2.0), min=1.0))
    V = env.cell_volume.to(torch.float32)
    V = V[..., None] if V.dim() else V
    xi_max = torch.maximum(num_a, num_b)
    xi_min = torch.minimum(num_a, num_b)
    p_evt = pair_scale * kk * xi_max * dt / V

    g_floor = torch.floor(p_evt)
    u_evt = rng.uniform(k_evt, p_evt.shape, p_evt.device)
    g = g_floor + (u_evt < (p_evt - g_floor)).to(torch.float32)
    both = (num_a > 0) & (num_b > 0)
    g = torch.where(both, torch.minimum(
        g, torch.floor(xi_max / torch.clamp(xi_min, min=1e-30))), 0.0)
    did = g > 0

    a_is_big = num_a >= num_b
    mb = a_is_big[..., None, :]
    big = torch.where(mb, A, B)
    sml = torch.where(mb, B, A)
    dec = g * xi_min
    new_big_num = torch.clamp(big[..., 0, :] - dec, min=0.0)
    big_dead = new_big_num <= 0.0
    out_big = big.clone()
    out_big[..., 0, :] = new_big_num
    out_big = torch.where(big_dead[..., None, :], 0.0, out_big)
    vol_new = sml[..., 6:6 + S, :] + g[..., None, :] * big[..., 6:6 + S, :]

    sv_out, si_out = _merge_components(sml, big, g, did, S, K)
    out_sml = sml.clone()
    out_sml[..., 6:6 + S, :] = torch.where(did[..., None, :], vol_new,
                                           sml[..., 6:6 + S, :])
    out_sml[..., 6 + S:6 + S + K, :] = sv_out.transpose(-1, -2)
    out_sml[..., 6 + S + K:6 + S + 2 * K, :] = si_out.transpose(-1, -2).to(torch.float32)

    parts = [torch.where(mb, out_big, out_sml), torch.where(mb, out_sml, out_big)]
    if P > 2 * n_pair:                                  # odd capacity
        parts.append(rows[..., 2 * n_pair:])
    out = torch.cat(parts, dim=-1).reshape(C, rows.shape[-2], P)
    st = unpack_payload(state, out)
    # primary source label follows the largest component
    top = torch.argmax(st.src_vol, dim=-2, keepdim=True)
    prim = torch.gather(st.src_id, -2, top)[..., 0, :]
    out_state = dataclasses.replace(
        st, source=torch.where((prim >= 0) & st.alive, prim, st.source))
    if not return_events:
        return out_state

    def pid_of(r):
        return (torch.round(r[..., 2, :]).to(torch.int32)
                + _PID_SPLIT * torch.round(r[..., 3, :]).to(torch.int32))
    removed = did & big_dead
    return out_state, {"removed_id": torch.where(removed, pid_of(big), -1),
                       "other_id": torch.where(removed, pid_of(sml), -1)}
