"""Stochastic particle transport driven by captured advective fluxes.

Port of ``wrf_partmc_tpu/models/coupled/transport.py``: per-face
horizontal probabilities (advective outflow + eddy diffusion), the
per-column vertical operator R = B^N A, the preweight acceptance, the
per-particle move draw, the rebucket that moves movers into free slots of
their destination cells, and the open-boundary outflow discard; on one
device (``transport_step``) or on each rank's block of a decomposed domain
(``transport_step_sharded``), where the movers of a block's edge columns go
to the neighbouring rank.

The rebucket keeps the reference's slot layout exactly: within-cell ranks of
each destination class are a per-class exclusive cumsum (the reference's bf16
triangular matmul gives the same integers; on the card the move draw, the
open-edge drop and these ranks are one launch of kernel K6,
``ops/moves.py``), the vertical ranks are
column-global with a random level rotation, the caps are
``max(16, min(P, P//16))``, and the full 33-channel payload moves in one
``scatter_rows`` (T1, kernel K2) and one ``scatter_rows`` + ``gather_rows``
pair (T2, kernels K2 and K3) — no channel slabs.
"""

from __future__ import annotations

import torch

from ...config import Config
from ...grid import Grid
from ...ops import moves
from ...ops.advection import OutflowProbs
from ...ops.place import gather_rows, scatter_rows
from ...ops.stencil import on_grid, shift
from ...parallel import halo
from ...parallel.mesh import Mesh
from ...utils import rng
from ...utils.at import set_at
from ...utils.timing import span
from ..partmc.aero_state import AeroState, payload_channel_list, unpack_payload


def horizontal_diffusion_probs(xkhh, grid: Grid, dt, rho3, cfg: Config):
    """Per-face horizontal eddy-diffusion move probabilities
    (pxm, pxp, pym, pyp), each [nz, ny, nx], from the actual density rho3.
    Face K/rho averages are wrapped on periodic axes and clamped on open
    ones."""
    msq = grid.msft * grid.msft
    bc_x = "periodic" if cfg.boundary.periodic_x else "clamp"
    bc_y = "periodic" if cfg.boundary.periodic_y else "clamp"

    def face(s, axis, rdx2, bc):
        k_f = 0.5 * (xkhh + shift(xkhh, s, axis, bc))
        r_f = 0.5 * (rho3 + shift(rho3, s, axis, bc))
        return torch.clamp(k_f * dt * msq * rdx2 * r_f
                           / torch.clamp(rho3, min=1e-10), 0.0, 0.2)

    rdx2 = grid.rdx * grid.rdx
    rdy2 = grid.rdy * grid.rdy
    return (face(-1, 2, rdx2, bc_x), face(1, 2, rdx2, bc_x),
            face(-1, 1, rdy2, bc_y), face(1, 1, rdy2, bc_y))


def vertical_operator(probs: OutflowProbs, exch_h, grid: Grid, dt, rho3, dz3,
                      n_sub_max: int = 1024):
    """Per-column, per-class transition matrix R = B^N A,
    [n_class, ny, nx, nz, nz], row-stochastic, from the actual densities
    and layer depths.  B is the one-substep explicit diffusion matrix, N the
    stable substep count (up to ``n_sub_max``) reached by repeated squaring
    over the bits of N."""
    nz = grid.nz
    dev = exch_h.device

    k_int = exch_h[1:-1]
    k_max = torch.amax(k_int, dim=0)
    dz_min2 = torch.amin(dz3, dim=0) ** 2
    n_need = torch.ceil(dt * 10.0 * k_max / torch.clamp(dz_min2, min=1e-10))
    n_sub = torch.clamp(n_need, 1, n_sub_max).to(torch.int32)
    tau = dt / n_sub.to(torch.float32)

    dzf = 0.5 * (dz3[1:] + dz3[:-1])
    rho_f = 0.5 * (rho3[1:] + rho3[:-1])
    coef = (rho_f / dzf) * k_int
    p_up = coef / (rho3[:-1] * dz3[:-1])
    p_dn = coef / (rho3[1:] * dz3[1:])
    p_up = torch.clamp(p_up.movedim(0, -1) * tau[..., None], 0.0, 0.45)
    p_dn = torch.clamp(p_dn.movedim(0, -1) * tau[..., None], 0.0, 0.45)

    eye = torch.eye(nz, dtype=torch.float32, device=dev)
    e_up = torch.diag(torch.ones(nz - 1, dtype=torch.float32, device=dev), 1)
    e_dn = torch.diag(torch.ones(nz - 1, dtype=torch.float32, device=dev), -1)
    up_row = torch.nn.functional.pad(p_up, (0, 1))
    dn_row = torch.nn.functional.pad(p_dn, (1, 0))
    stay = 1.0 - up_row - dn_row
    B = (stay[..., None] * eye + up_row[..., None] * e_up
         + dn_row[..., None] * e_dn)

    M = eye.expand(B.shape)
    Bp = B
    for i in range(max(1, int(n_sub_max).bit_length())):
        bit = ((n_sub >> i) & 1).bool()[..., None, None]
        M = torch.where(bit, torch.matmul(M, Bp), M)
        Bp2 = torch.matmul(Bp, Bp)
        Bp = Bp2 / torch.clamp(torch.sum(Bp2, dim=-1, keepdim=True), min=1e-12)
    BN = M / torch.clamp(torch.sum(M, dim=-1, keepdim=True), min=1e-12)

    zm = probs.zm.movedim(1, -1)                   # [n_class, ny, nx, nz]
    zp = probs.zp.movedim(1, -1)
    stay_a = torch.clamp(1.0 - zm - zp, 0.0, 1.0)
    A = stay_a[..., None] * eye + zp[..., None] * e_up + zm[..., None] * e_dn
    R = torch.matmul(BN[None], A)
    return R / torch.clamp(torch.sum(R, dim=-1, keepdim=True), min=1e-12)


def normalized_face_probs(probs: OutflowProbs, p_hdiff):
    """Per-(class, cell) horizontal face probabilities with eddy diffusion
    added, renormalized where they sum above one.  Each [n_class, nz, ny, nx]."""
    hxm, hxp, hym, hyp = p_hdiff
    pxm = probs.xm + hxm[None]
    pxp = probs.xp + hxp[None]
    pym = probs.ym + hym[None]
    pyp = probs.yp + hyp[None]
    total = pxm + pxp + pym + pyp
    scale = torch.where(total > 1.0, 1.0 / torch.clamp(total, min=1e-12), 1.0)
    return pxm * scale, pxp * scale, pym * scale, pyp * scale


def _count_by_class(mask, w_class, n_class: int):
    """[C, nz, ny, nx] count of ``mask`` particles per weight class."""
    return torch.stack([torch.sum(mask & (w_class == c), dim=-1, dtype=torch.float32)
                        for c in range(n_class)])


def _pad_periodic(f):
    """f [..., ny, nx] with a one-cell periodic halo on its last two axes."""
    f = torch.cat([f[..., -1:, :], f, f[..., :1, :]], dim=-2)
    return torch.cat([f[..., -1:], f, f[..., :1]], dim=-1)


def preweight_acceptance(aero: AeroState, ph, R, cfg: Config, mesh: Mesh | None = None):
    """Pre-sampling acceptance [nz, ny, nx] in [1/8, 1] that bounds the
    expected arrivals at each cell by its free capacity (the reference's
    ``trans_aero_preweight``).  On an open axis nothing arrives from
    outside the domain.  With ``mesh``, ``aero``/``ph``/``R`` are this
    rank's block and the neighbours' expected movers come through a
    one-cell halo exchange (``halo.exchange_2d``)."""
    pxm, pxp, pym, pyp = ph
    n_cf = _count_by_class(aero.alive, aero.w_class, ph[0].shape[0])

    # expected movers through each face, with a one-cell halo; a mover
    # through my east neighbour's west face (-x) lands in me, and so on
    movers = torch.stack([pxm * n_cf, pxp * n_cf, pym * n_cf, pyp * n_cf])
    pad = _pad_periodic(movers) if mesh is None else halo.exchange_2d(movers, 1, mesh)
    arr_xm = pad[0][..., 1:-1, 2:]
    arr_xp = pad[1][..., 1:-1, :-2]
    arr_ym = pad[2][..., 2:, 1:-1]
    arr_yp = pad[3][..., :-2, 1:-1]
    first_y = first_x = last_y = last_x = True
    if mesh is not None:
        first_y, last_y = mesh.iy == 0, mesh.iy == mesh.py - 1
        first_x, last_x = mesh.ix == 0, mesh.ix == mesh.px - 1
    if not cfg.boundary.periodic_x:
        if last_x:
            arr_xm = set_at(arr_xm, -1, 0.0, dim=-1)
        if first_x:
            arr_xp = set_at(arr_xp, 0, 0.0, dim=-1)
    if not cfg.boundary.periodic_y:
        if last_y:
            arr_ym = set_at(arr_ym, -1, 0.0, dim=-2)
        if first_y:
            arr_yp = set_at(arr_yp, 0, 0.0, dim=-2)

    stay_h = torch.clamp(1.0 - (pxm + pxp + pym + pyp), 0.0, 1.0)
    n_nh = stay_h * n_cf                                       # [C,nz,ny,nx]
    arr_v = torch.einsum("cyxsd,csyx->cdyx", R, n_nh)
    diag_r = torch.diagonal(R, dim1=-2, dim2=-1).movedim(-1, 1)
    n_keep = torch.sum(n_nh * diag_r, dim=0)

    n_in = torch.sum(arr_v + arr_xm + arr_xp + arr_ym + arr_yp, dim=0) - n_keep
    free = torch.clamp(0.95 * aero.capacity - n_keep, min=0.0)
    acc = torch.where(n_in > free, free / torch.clamp(n_in, min=1e-6), 1.0)
    return torch.clamp(acc, min=1.0 / 8.0)


def sample_moves(aero: AeroState, ph, R, key):
    """Raw per-particle move draw: (dj, di, dest_k, horizontal), each
    [nz, ny, nx, P].  A particle first tries one horizontal face, otherwise
    draws its new level from its column's R row (inverse CDF)."""
    u, u2 = _move_uniforms(aero, key)
    return moves.draw_moves(u, u2, aero.w_class, ph, torch.cumsum(R, dim=-1))


def _move_uniforms(aero: AeroState, key):
    """The move draw's two uniforms [nz, ny, nx, P]: the face, then the level."""
    k_h, k_v = rng.split(key)
    return (rng.uniform(k_h, aero.num.shape, aero.num.device),
            rng.uniform(k_v, aero.num.shape, aero.num.device))


def _edges(cfg: Config, shape, grid: Grid | None = None) -> moves.Edges:
    """The open-edge drop's view of a block of ``shape`` [.., ny_l, nx_l, P]
    cells: the global indices of the cells of ``grid`` (the whole domain, or
    a rank's block; None: the block's own extents)."""
    nyl, nxl = shape[1], shape[2]
    ny, nx = (nyl, nxl) if grid is None else grid.global_shape
    iy0, ix0 = (0, 0) if grid is None else grid.offsets
    return moves.Edges(iy0, ix0, ny, nx, not cfg.boundary.periodic_y,
                       not cfg.boundary.periodic_x)


def open_boundary_drop(dj, di, horizontal, cfg: Config, grid: Grid | None = None):
    """[nz, ny, nx, P] mask of particles sampled across an open lateral
    boundary (the reference's outflow discard), from the global indices of
    the cells of ``grid`` (the whole domain, or a rank's block; None: the
    arrays' own extents)."""
    return moves.edge_drop(dj, di, horizontal, _edges(cfg, dj.shape, grid))


# transport steps, and the K6 launches among them (one a step on the card)
K6_COUNTS = {"steps": 0, "k6": 0}


def move_ranks(aero: AeroState, ph, R, key, cfg: Config, grid: Grid | None = None):
    """The move draw of :func:`sample_moves` through the open-edge drop to
    the destination codes, within-cell class ranks and class counts
    (``dcode``, ``rank_p``, ``cnt``; ``ops/moves.py``): one K6 launch on a
    CUDA state, the plain chain on the CPU."""
    u, u2 = _move_uniforms(aero, key)
    launched = moves.move_ranks_cuda.launches
    out = moves.move_ranks(u, u2, aero.num, aero.w_class, ph, torch.cumsum(R, dim=-1),
                           _edges(cfg, aero.num.shape, grid))
    K6_COUNTS["steps"] += 1
    K6_COUNTS["k6"] += moves.move_ranks_cuda.launches - launched
    return out


def _caps(cfg: Config, P: int):
    """Per-(source-cell, destination-class) mover caps (vertical, horizontal).
    Kept exactly: where they saturate they change the results."""
    av = cfg.partmc.trans_cap_v or max(16, min(P, P // 16))
    ah = cfg.partmc.trans_cap_h or max(16, P // 16)
    return av, ah


def _reorder_minis(minis, nz, nyl, nxl, ch, Av, Ah, roll=None):
    """Per-cell mover mini-regions [C, ch, F1] -> per-destination-cell arrival
    buffers [C, ch, Av + 4 Ah].  Vertical ranks are column-global, so each
    (dest level, rank) slot is claimed by at most one source cell and the
    column arrival buffer is the sum over source levels; horizontal movers
    shift one column over.  The shift wraps, which is right on a periodic
    axis and harmless on an open one: movers across an open edge were
    dropped before, so the wrapped rows are empty.  ``roll(slab, shift,
    axis)`` replaces ``torch.roll`` for the horizontal shifts (on a block,
    the wrapped column comes from the neighbouring rank)."""
    roll = roll or (lambda slab, sh, axis: torch.roll(slab, sh, dims=axis))
    C = nz * nyl * nxl
    F1 = nz * Av + 4 * Ah
    m5 = minis.reshape(nz, nyl, nxl, ch, F1)
    col = torch.sum(m5[..., :nz * Av], dim=0).reshape(nyl, nxl, ch, nz, Av)
    arr_v = col.movedim(3, 0)                        # [kd, ny, nx, ch, Av]
    mh = m5[..., nz * Av:].reshape(nz, nyl, nxl, ch, 4, Ah)
    arr_w = roll(mh[..., 0, :], -1, 2)
    arr_e = roll(mh[..., 1, :], 1, 2)
    arr_s = roll(mh[..., 2, :], -1, 1)
    arr_n = roll(mh[..., 3, :], 1, 1)
    arr = torch.cat([arr_v, arr_w, arr_e, arr_s, arr_n], dim=-1)
    return arr.reshape(C, ch, Av + 4 * Ah)


def rebucket(aero: AeroState, dest_k, dj, di, horizontal, drop, acc, cfg: Config,
             key, roll=None):
    """Move particles to their sampled destination cells; ``drop`` marks
    particles leaving an open domain, which vanish.  ``roll``: the
    horizontal shift of ``_reorder_minis`` (a block's edge exchange).
    Returns (new_aero, diag) with the overflow counters: the plain
    destination codes and class ranks (``ops/moves.py``), then
    :func:`rebucket_codes`."""
    dcode = moves.move_codes(aero.alive, dest_k, dj, di, horizontal, drop)
    rank_p, cnt = moves.class_ranks(dcode, aero.num.shape[0] + 4)
    return rebucket_codes(aero, dcode, rank_p, cnt, acc, cfg, key, roll)


def rebucket_codes(aero: AeroState, dcode, rank_p, cnt, acc, cfg: Config, key, roll=None):
    """The rebucket from each slot's destination class ``dcode`` [C, P]
    (0..nz-1 a vertical target level, nz+d a horizontal face W/E/S/N,
    ``moves.STAY``, ``moves.GONE``), its within-cell rank ``rank_p`` among
    the movers of its class and the class counts ``cnt`` [C, nz + 4]:

    * ranks: a column-global offset for vertical classes taken over source
      levels in a randomly rotated order;
    * T1: movers within their pool's cap are scattered into per-cell
      mini-regions (kernel K2); the pool's departing number is carried by
      the shipped movers (conservation scale);
    * phase 1b: destination-side preweight thinning of the arrivals, free
      slot and arrival ranks;
    * T2: kept arrivals are compacted by rank (K2) and each free slot
      gathers its rank'th arrival (K3); stayers keep their slots.
    """
    nz, nyl, nxl, P = aero.num.shape
    C = nz * nyl * nxl
    dev = aero.num.device
    Av, Ah = _caps(cfg, P)
    F1 = nz * Av + 4 * Ah
    AB = Av + 4 * Ah
    D = nz + 4

    k_thin, k_rot = rng.split(key)

    with span("wpmc.transport.ranks"):
        mover = dcode >= 0
        num_flat = aero.num.reshape(C, P)
        cnt4 = cnt.reshape(nz, nyl, nxl, D)
        # column-global vertical ranks, source levels visited in a randomly
        # rotated order
        rot = rng.randint_scalar(k_rot, 0, nz)
        a = torch.roll(cnt4, -rot, dims=0)
        offs4 = torch.roll(torch.cumsum(a, dim=0) - a, rot, dims=0)
        is_v_d = torch.arange(D, device=dev) < nz
        offs_cd = torch.where(is_v_d, offs4, 0.0).reshape(C, D)
        dsafe = dcode.clamp(min=0).long()
        offs_p = torch.where(mover, torch.gather(offs_cd, 1, dsafe), 0.0)
        rank_g = (rank_p + offs_p.to(torch.int32)) * mover
        del offs_p

        is_v_p = dcode < nz
        cap_p = torch.where(is_v_p, Av, Ah)
        ship = mover & (rank_g < cap_p)
        base_p = torch.where(is_v_p, dcode * Av, nz * Av + (dcode - nz) * Ah)
        dst1 = torch.where(ship, base_p + rank_g, -1).to(torch.int32)
        del rank_g, is_v_p, cap_p, base_p

    with span("wpmc.transport.t1"):
        # pool conservation: shipped movers of each pool carry the pool's whole
        # departing number (vertical pools span the column)
        shipped_num = torch.where(ship, num_flat, 0.0)
        tot_cd, shp_cd = [], []
        for d in range(D):                  # one class's mask at a time
            m = dcode == d
            tot_cd.append(torch.sum(torch.where(m, num_flat, 0.0), dim=-1))
            shp_cd.append(torch.sum(torch.where(m, shipped_num, 0.0), dim=-1))
        del m, shipped_num
        tot_cd, shp_cd = torch.stack(tot_cd, -1), torch.stack(shp_cd, -1)
        tot4 = tot_cd.reshape(nz, nyl, nxl, D)
        shp4 = shp_cd.reshape(nz, nyl, nxl, D)
        tot_pool = torch.where(is_v_d, torch.sum(tot4, 0, keepdim=True), tot4)
        shp_pool = torch.where(is_v_d, torch.sum(shp4, 0, keepdim=True), shp4)
        sc4 = torch.where(shp_pool > 0.0, tot_pool / torch.clamp(shp_pool, min=0.0), 1.0)
        scale_p = torch.gather(sc4.reshape(C, D), 1, dsafe)
        num_all = torch.where(ship, num_flat * torch.clamp(scale_p, min=1.0), num_flat)
        del dsafe, scale_p, ship

        cnt_pool_v = torch.sum(cnt4, dim=0)[..., :nz]
        ovf_class = (torch.sum(torch.clamp(cnt_pool_v - Av, min=0.0))
                     + torch.sum(torch.clamp(cnt4[..., nz:] - Ah, min=0.0)))

        # T1: the full payload (num replaced by the conserving num_all) through
        # the mover mini-regions; rows that do not ship have dst -1 and drop
        parts = [p.reshape(C, P) for p in payload_channel_list(aero)]
        parts[0] = num_all
        payload = torch.stack(parts, dim=1)             # [C, CH, P]
        CH = payload.shape[1]
        minis = scatter_rows(payload, dst1, F1)
        arr = _reorder_minis(minis, nz, nyl, nxl, CH, Av, Ah, roll).contiguous()
        del minis

    with span("wpmc.transport.thin"):
        # phase 1b: destination-side preweight thinning, then arrival/free ranks
        a_num = arr[:, 0, :]
        u = rng.uniform(k_thin, (C, AB), dev)
        acc_c = acc.reshape(C, 1)
        keep = (u < acc_c) & (a_num > 0.0)
        a_num_th = torch.where(keep, a_num / torch.clamp(acc_c, min=1e-6), 0.0)
        tot_arr = torch.sum(a_num_th, dim=-1)
        arr[:, 0, :] = a_num_th

        stay_keep = dcode == moves.STAY
        free = ~stay_keep
        n_free = torch.sum(free, dim=-1)
        f_rank = torch.cumsum(free, dim=-1) - 1
        k_rank = torch.cumsum(keep, dim=-1) - 1
        placed = keep & (k_rank < n_free[:, None])
        n_kept = torch.sum(placed, dim=-1)
        ovf_free = torch.sum(keep & ~placed, dtype=torch.float32)

    with span("wpmc.transport.t2"):
        # T2: compact kept arrivals by rank, each free slot gathers its rank'th
        # arrival; stayers keep their payload (a select: the two sets of slots
        # are disjoint, as the reference's arrived + payload * stay merge)
        dstc = torch.where(placed, k_rank, -1).to(torch.int32)
        srcp = torch.where(free & (f_rank < n_kept[:, None]), f_rank, -1).to(torch.int32)
        arrived = gather_rows(scatter_rows(arr, dstc, AB), srcp)
        merged = torch.where(stay_keep[:, None, :], payload, arrived)
        del payload, arrived

    with span("wpmc.transport.unpack"):
        # free-slot overflow fold: arrival number that found no free slot is
        # folded onto the whole cell by a multiplicity rescale
        stay_num = torch.sum(torch.where(stay_keep, num_flat, 0.0), dim=-1)
        actual = torch.sum(merged[:, 0, :], dim=-1)
        scale_cell = torch.where(actual > 0,
                                 (stay_num + tot_arr) / torch.clamp(actual, min=0.0), 1.0)
        merged[:, 0, :] *= torch.clamp(scale_cell, min=1.0)[:, None]

        new = unpack_payload(aero, merged)
        diag = {"overflow_class": ovf_class, "overflow_free": ovf_free,
                "movers": torch.sum(mover, dtype=torch.float32)}
    return new, diag


def edge_roll(mesh: Mesh):
    """The roll hook of a block's rebucket: shift the mover mini-buffers one
    column (``axis`` 2, x) or row (1, y) over and patch the wrapped column
    with the neighbouring rank's edge buffer, as the JAX package's
    periodic ``ppermute`` does (an edge rank of an open domain receives
    the far edge's buffer, empty because its movers were dropped)."""
    def roll(slab, sh, axis):
        rolled = torch.roll(slab, sh, dims=axis)
        name = "x" if axis == 2 else "y"
        if mesh.extent(name) == 1:
            return rolled
        n = slab.shape[axis]
        # shift -1: the wrapped entry is the last and comes from the +1
        # rank's first; shift +1: the first, from the -1 rank's last
        send_at, put_at = (0, n - 1) if sh == -1 else (n - 1, 0)
        edge = halo.neighbor_shift(slab.narrow(axis, send_at, 1), sh, mesh, name)
        rolled.narrow(axis, put_at, 1).copy_(edge)
        return rolled
    return roll


def transport_step_sharded(aero: AeroState, probs: OutflowProbs, xkhh, exch_h,
                           grid: Grid, cfg: Config, dt, key, mesh: Mesh, rho3, dz3):
    """Transport of this rank's block of the particles (the JAX package's
    ``transport_step_sharded``).  ``grid`` is the rank's block grid and the
    fields (``probs``, ``xkhh``, ``exch_h``, ``rho3``, ``dz3``) its blocks:
    the face probabilities take the neighbours' ``xkhh`` and ``rho3`` through
    the block stencils' one-cell halo, the column-local vertical operator
    is built on the block's columns.  Each rank draws its moves with the
    key folded by its mesh row, then column, rebuckets its block and sends
    the movers of its edge columns to the neighbouring rank
    (:func:`edge_roll`); the diagnostics are summed over the ranks."""
    if grid.mesh != mesh:
        raise ValueError("transport_step_sharded: the grid is not this mesh's block grid")
    with span("wpmc.transport.probs"):
        with on_grid(grid):
            p_hdiff = horizontal_diffusion_probs(xkhh, grid, dt, rho3, cfg)
        ph = normalized_face_probs(probs, p_hdiff)
        R = vertical_operator(probs, exch_h, grid, dt, rho3, dz3)
        acc = preweight_acceptance(aero, ph, R, cfg, mesh)
    with span("wpmc.transport.sample"):
        k = rng.fold_in(rng.fold_in(key, mesh.iy), mesh.ix)
        k_mv, k_thin = rng.split(k)
        dcode, rank_p, cnt = move_ranks(aero, ph, R, k_mv, cfg, grid)
    new, diag = rebucket_codes(aero, dcode, rank_p, cnt, acc, cfg, k_thin,
                               roll=edge_roll(mesh))
    names = list(diag)
    total = halo.all_reduce_sum(torch.stack([diag[n] for n in names]), mesh)
    return new, dict(zip(names, total.unbind(0)))


def transport_step(aero: AeroState, probs: OutflowProbs, xkhh, exch_h,
                   grid: Grid, cfg: Config, dt, key, rho3, dz3, mesh: Mesh | None = None):
    """Full stochastic transport step: probabilities -> move draw ->
    rebucket with destination-side preweight thinning.  Particles sampled
    across an open lateral boundary are removed.  With ``mesh``, ``aero``
    is this rank's block (:func:`transport_step_sharded`).  Returns
    (new_aero, diag)."""
    if mesh is not None:
        return transport_step_sharded(aero, probs, xkhh, exch_h, grid, cfg, dt, key,
                                      mesh, rho3, dz3)
    k_mv, k_thin = rng.split(key)
    with span("wpmc.transport.probs"):
        p_hdiff = horizontal_diffusion_probs(xkhh, grid, dt, rho3, cfg)
        ph = normalized_face_probs(probs, p_hdiff)
        R = vertical_operator(probs, exch_h, grid, dt, rho3, dz3)
        acc = preweight_acceptance(aero, ph, R, cfg)
    with span("wpmc.transport.sample"):
        dcode, rank_p, cnt = move_ranks(aero, ph, R, k_mv, cfg)
    return rebucket_codes(aero, dcode, rank_p, cnt, acc, cfg, k_thin)
