"""Fixed-capacity particle population state.

Port of ``wrf_partmc_tpu/models/partmc/aero_state.py``: per-cell particle
storage is a fixed-capacity SoA (``vol[..., S, P]``, ``num[..., P]``, ...)
with ``num == 0`` marking dead slots, and every particle carries its own
multiplicity.  The TPU workarounds of the reference (one-hot ``take_e``,
iota scatter+gather slot inversion) are direct index ops here and give the
same slot layouts.

The packed payload keeps the reference's channel order
(:func:`payload_channel_list`), integer fields stored as float values (exact
in f32 below 2**24): the arithmetic merges of the transport rebucket rely on
it, and the row kernels move every channel bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ...utils import rng
from .aero_data import AeroData, particle_volume, vol_to_diam

_PID_SPLIT = 4096   # pid rides in two value channels (lo, hi), as in the reference


@dataclass(frozen=True)
class AeroState:
    vol: torch.Tensor        # [..., S, P] per-species volume per particle [m3]
    num: torch.Tensor        # [..., P] multiplicity (physical particles); 0=dead
    pid: torch.Tensor        # [..., P] int32 particle id (unique within cell)
    source: torch.Tensor     # [..., P] int32 primary source
    w_class: torch.Tensor    # [..., P] int32 weight class
    t_create: torch.Tensor   # [..., P] f32 creation time [s]
    next_id: torch.Tensor    # [...] int32 id counter
    src_id: torch.Tensor     # [..., K, P] int32 source index, -1 = empty
    src_vol: torch.Tensor    # [..., K, P] f32 attributed primary volume [m3]
    hyst_leg: torch.Tensor   # [..., P] int32 water-hysteresis leg

    @property
    def capacity(self) -> int:
        return self.num.shape[-1]

    @property
    def n_src_comp(self) -> int:
        return self.src_id.shape[-2]

    @property
    def cell_shape(self) -> tuple:
        return tuple(self.num.shape[:-1])

    @property
    def alive(self) -> torch.Tensor:
        return self.num > 0.0

    def n_alive(self) -> torch.Tensor:
        return torch.sum(self.alive, dim=-1)

    def total_num(self) -> torch.Tensor:
        """Total represented physical-particle number per cell [...]."""
        return torch.sum(self.num, dim=-1)

    def num_by_class(self, n_class: int) -> torch.Tensor:
        """[..., n_class] represented number per weight class, one masked
        reduction per class (no [.., C, P] one-hot)."""
        return torch.stack([torch.sum(torch.where(self.w_class == c, self.num, 0.0), dim=-1)
                            for c in range(n_class)], dim=-1)

    def dry_diameter(self, aero_data: AeroData) -> torch.Tensor:
        return vol_to_diam(particle_volume(self.vol, dry=True, aero_data=aero_data))

    def wet_diameter(self) -> torch.Tensor:
        return vol_to_diam(particle_volume(self.vol))


def zero_state(aero_data: AeroData, capacity: int, cell_shape=(),
               n_src_comp: int = 3, device="cpu") -> AeroState:
    S = aero_data.n_spec
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    i = lambda v, *s: torch.full(s, v, dtype=torch.int32, device=device)
    return AeroState(
        vol=f(*cell_shape, S, capacity), num=f(*cell_shape, capacity),
        pid=i(0, *cell_shape, capacity), source=i(0, *cell_shape, capacity),
        w_class=i(0, *cell_shape, capacity),
        t_create=f(*cell_shape, capacity), next_id=i(0, *cell_shape),
        src_id=i(-1, *cell_shape, n_src_comp, capacity),
        src_vol=f(*cell_shape, n_src_comp, capacity),
        hyst_leg=i(1, *cell_shape, capacity))


def payload_channels(state: AeroState) -> int:
    return 7 + state.vol.shape[-2] + 2 * state.n_src_comp


def payload_channel_list(state: AeroState) -> list:
    """The per-particle payload as CH [..., P] f32 tensors in pack order:
    [num, t_create, pid_lo, pid_hi, source, w_class, vol(S), src_vol(K),
    src_id(K), hyst_leg]."""
    f = lambda a: a.to(torch.float32)
    parts = [state.num, state.t_create,
             f(torch.remainder(state.pid, _PID_SPLIT)),
             f(torch.div(state.pid, _PID_SPLIT, rounding_mode="floor")),
             f(state.source), f(state.w_class)]
    parts += list(state.vol.unbind(-2))
    parts += list(state.src_vol.unbind(-2))
    parts += [f(a) for a in state.src_id.unbind(-2)]
    parts.append(f(state.hyst_leg))
    return parts


def pack_payload(state: AeroState) -> torch.Tensor:
    """All per-particle fields as one contiguous [C, CH, P] f32 tensor."""
    payload = torch.stack(payload_channel_list(state), dim=-2)
    return payload.reshape(-1, payload_channels(state), state.capacity)


def unpack_payload(state: AeroState, payload) -> AeroState:
    """Inverse of pack_payload for payload [C, CH, P]; integer channels are
    rounded and rows with num <= 0 are fully zeroed (dead-slot defaults)."""
    S = state.vol.shape[-2]
    K = state.n_src_comp
    cs = state.cell_shape
    P = state.capacity
    p = payload.transpose(0, 1).reshape(payload.shape[-2], *cs, P)
    ii = lambda a: torch.round(a).to(torch.int32)
    num = p[0]
    dead = num <= 0.0
    pid = ii(p[2]) + _PID_SPLIT * ii(p[3])
    zero_i = torch.zeros((), dtype=torch.int32, device=num.device)
    return dataclasses.replace(
        state,
        num=torch.where(dead, 0.0, num),
        t_create=p[1].contiguous(),
        pid=torch.where(dead, zero_i, pid),
        source=torch.where(dead, zero_i, ii(p[4])),
        w_class=torch.where(dead, zero_i, ii(p[5])),
        vol=torch.where(dead[None], 0.0, p[6:6 + S]).movedim(0, -2).contiguous(),
        src_vol=torch.where(dead[None], 0.0,
                            p[6 + S:6 + S + K]).movedim(0, -2).contiguous(),
        src_id=torch.where(dead[None], zero_i - 1,
                           ii(p[6 + S + K:6 + S + 2 * K])).movedim(0, -2).contiguous(),
        hyst_leg=torch.where(dead, zero_i + 1, ii(p[6 + S + 2 * K])))


def permute_slots(state: AeroState, dst) -> AeroState:
    """Move each particle to slot ``dst[..., p]`` of its own cell (-1
    drops), through ``scatter_rows`` (kernel K2 on CUDA)."""
    from ...ops.place import scatter_rows

    P = state.capacity
    rows = scatter_rows(pack_payload(state), dst.reshape(-1, P).to(torch.int32).contiguous(), P)
    return unpack_payload(state, rows)


def compact(state: AeroState) -> AeroState:
    """Stable-move alive particles to the front of the slot axis (the
    reference's ``aero_sorted`` re-sort).  Nothing on the coupled step
    needs it: transport, emission and rebalance work on fragmented
    populations through rank computations."""
    alive = state.alive
    rank = torch.cumsum(alive.to(torch.int32), dim=-1) - 1
    return permute_slots(state, torch.where(alive, rank, -1))


def fill_fresh(aero_data: AeroData, capacity: int, new_vol, new_num,
               new_source, new_w_class, time=0.0,
               n_src_comp: int = 3) -> AeroState:
    """A brand-new population from E sampled entries per cell (entry e ->
    slot e)."""
    cs = tuple(new_num.shape[:-1])
    E = new_num.shape[-1]
    P = capacity
    if E > P:
        raise ValueError(f"fill_fresh: E={E} > capacity={P}")
    dev = new_num.device
    pad = lambda a: torch.nn.functional.pad(a, (0, P - E))
    num = pad(new_num.to(torch.float32))
    vol = pad(new_vol.to(torch.float32))
    alive = num > 0.0
    src = pad(new_source.to(torch.int32).expand(*cs, E))
    wcl = pad(new_w_class.to(torch.int32).expand(*cs, E))
    pid = torch.arange(P, dtype=torch.int32, device=dev).expand(*cs, P)
    tot_v = torch.sum(vol, dim=-2)
    K = n_src_comp
    sv = torch.cat([tot_v[..., None, :],
                    torch.zeros((*cs, K - 1, P), dtype=torch.float32, device=dev)], dim=-2)
    si = torch.cat([src[..., None, :],
                    torch.full((*cs, K - 1, P), -1, dtype=torch.int32, device=dev)], dim=-2)
    dead = ~alive
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    return AeroState(
        vol=torch.where(dead[..., None, :], 0.0, vol),
        num=torch.where(dead, 0.0, num),
        pid=torch.where(dead, zi, pid),
        source=torch.where(dead, zi, src),
        w_class=torch.where(dead, zi, wcl),
        t_create=torch.full((*cs, P), float(time), dtype=torch.float32, device=dev),
        next_id=torch.full(cs, E, dtype=torch.int32, device=dev),
        src_id=torch.where(dead[..., None, :], zi - 1, si),
        src_vol=torch.where(dead[..., None, :], 0.0, sv),
        hyst_leg=torch.ones((*cs, P), dtype=torch.int32, device=dev))


def add_particles(state: AeroState, new_vol, new_num, new_source, new_w_class,
                  time=0.0) -> AeroState:
    """Append up to E new particles per cell into free slots: entry e lands
    in the cell's e-th free slot (a rank cumsum), for any E.  Overflow beyond
    capacity is dropped with its number conserved by rescaling the placed
    entries.  Entries whose number is 0 after that rescale leave dead slots.
    For E <= 64, like the reference's one-hot path, such a slot still takes
    the entry's pid, source, weight class, creation time and ``src_id``, so
    there dead slots compare only by ``num == 0``.  For E > 64, like the
    reference's ``_add_particles_large``, only live entries are placed and
    every field of a dead entry's slot is left as it was."""
    E = new_num.shape[-1]
    cs = state.cell_shape
    free = ~state.alive
    f_rank = torch.cumsum(free.to(torch.int32), dim=-1) - 1
    incoming = free & (f_rank < E)
    e_safe = torch.clamp(f_rank, 0, E - 1).long()

    n_free = torch.sum(free, dim=-1)
    e_rank = torch.arange(E, dtype=torch.int64, device=free.device)
    placed_mask = e_rank < n_free[..., None]
    tot = torch.sum(new_num, dim=-1)
    placed = torch.sum(new_num * placed_mask, dim=-1)
    scale = torch.where(placed > 0, tot / torch.clamp(placed, min=0.0), 1.0)
    new_num = new_num * placed_mask * scale[..., None]

    take = lambda a: torch.gather(a.expand(*cs, E), -1, e_safe)
    if E > 64:
        incoming = incoming & (take(new_num) > 0)
    num = torch.where(incoming, take(new_num), state.num)
    src_e = take(new_source.to(torch.int32))
    src = torch.where(incoming, src_e, state.source)
    wcl = torch.where(incoming, take(new_w_class.to(torch.int32)), state.w_class)
    pid = torch.where(incoming, state.next_id[..., None] + e_safe.to(torch.int32),
                      state.pid)
    tcr = torch.where(incoming, float(time), state.t_create)
    S = new_vol.shape[-2]
    vol_in = torch.gather(new_vol.expand(*cs, S, E), -1,
                          e_safe[..., None, :].expand(*cs, S, e_safe.shape[-1]))
    inc_k = incoming[..., None, :]
    dead_in = (incoming & ~(num > 0))[..., None, :]
    vol = torch.where(dead_in, 0.0, torch.where(inc_k, vol_in, state.vol))
    # a fresh particle is 100% its emitting source
    tot_v = take(torch.sum(new_vol, dim=-2))
    sv_new = torch.zeros_like(state.src_vol)
    sv_new[..., 0, :] = tot_v
    src_vol = torch.where(dead_in, 0.0, torch.where(inc_k, sv_new, state.src_vol))
    si_new = torch.full_like(state.src_id, -1)
    si_new[..., 0, :] = src_e
    src_id = torch.where(inc_k, si_new, state.src_id)
    one = torch.ones((), dtype=torch.int32, device=free.device)
    return dataclasses.replace(
        state, vol=vol, num=torch.where(incoming & ~(num > 0), 0.0, num),
        pid=pid, source=src, w_class=wcl, t_create=tcr,
        next_id=state.next_id + E, src_vol=src_vol, src_id=src_id,
        hyst_leg=torch.where(incoming, one, state.hyst_leg))


def thin(state: AeroState, keep_prob, key) -> AeroState:
    """Keep each alive particle with probability ``keep_prob`` (per cell),
    dividing kept multiplicities by it (number conserved in expectation)."""
    u = rng.uniform(key, state.num.shape, state.num.device)
    kp = keep_prob[..., None].expand(state.num.shape)
    keep = (u < kp) & state.alive
    num = torch.where(keep, state.num / torch.clamp(kp, min=1e-12), 0.0)
    return dataclasses.replace(
        state, num=num, vol=torch.where(keep[..., None, :], state.vol, 0.0))


def split_largest(state: AeroState) -> AeroState:
    """Double the particle count: the r-th free slot receives a half-weight
    copy of the r-th alive particle (cells with 2 n_alive > capacity are left
    untouched).  The copies move through ``gather_rows`` (kernel K3)."""
    from ...ops.place import gather_rows

    P = state.capacity
    alive = state.alive
    n0 = state.n_alive()
    can = 2 * n0 <= P
    f_rank = torch.cumsum((~alive).to(torch.int32), dim=-1) - 1
    # slot of the r-th alive particle: alive slots first, in slot order
    slot_of_rank = torch.argsort((~alive).to(torch.int8), dim=-1, stable=True)
    is_copy = (~alive) & (f_rank < n0[..., None]) & can[..., None]
    src_slot = torch.gather(slot_of_rank, -1, torch.clamp(f_rank, min=0).long())
    src_slot = torch.where(is_copy, src_slot, -1).to(torch.int32)
    copies = gather_rows(pack_payload(state), src_slot.reshape(-1, P).contiguous())
    copied = unpack_payload(state, copies)

    is_copy = is_copy & (copied.num > 0.0)
    halve = (alive & can[..., None]) | is_copy

    def merge(orig, cp):
        if orig.dim() == is_copy.dim() + 1:
            return torch.where(is_copy[..., None, :], cp, orig)
        return torch.where(is_copy, cp, orig)

    num = torch.where(halve, merge(state.num, copied.num) * 0.5, state.num)
    pid = torch.where(is_copy, (state.next_id[..., None] + f_rank).to(torch.int32),
                      state.pid)
    return dataclasses.replace(
        state, num=num, pid=pid,
        t_create=merge(state.t_create, copied.t_create),
        source=merge(state.source, copied.source),
        w_class=merge(state.w_class, copied.w_class),
        vol=merge(state.vol, copied.vol),
        src_vol=merge(state.src_vol, copied.src_vol),
        src_id=merge(state.src_id, copied.src_id),
        hyst_leg=merge(state.hyst_leg, copied.hyst_leg),
        next_id=state.next_id + torch.where(can, n0, 0).to(torch.int32))


def rebalance(state: AeroState, key, n_ideal: int, allow_halving=True,
              allow_doubling=True) -> AeroState:
    """Keep per-cell computational-particle counts near ``n_ideal``: halve
    by a thin where n >= 2 n_ideal; double (split) where 0 < n < n_ideal//2.
    The doubling pass runs only when some cell needs it (a host check, the
    counterpart of the reference's ``lax.cond``)."""
    st = state
    if allow_halving:
        need = st.n_alive() >= 2 * n_ideal
        st = thin(st, torch.where(need, 0.5, 1.0), key)
    if allow_doubling:
        n = st.n_alive()
        need = (n > 0) & (n < n_ideal // 2)
        if bool(need.any()):
            doubled = split_largest(st)

            def pick(a, b):
                return torch.where(need.reshape(need.shape + (1,) * (a.dim() - need.dim())),
                                   a, b)

            st = AeroState(**{f.name: pick(getattr(doubled, f.name), getattr(st, f.name))
                              for f in dataclasses.fields(AeroState)})
    return st
