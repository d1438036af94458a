"""The transport's move draw, open-edge drop and class ranks (K6,
``ops/moves.py``).

On the CPU: the plain per-class ranks against ranks read off a stable sort
of the codes, the step's front (``transport.move_ranks``) against the
public chain it replaces, and the kernel's wrapper refusing CPU tensors.
On the card (``-m gpu``; skipped without one):

    python -m pytest --noconftest -m gpu tests/test_torch_moves.py

K6 bit-equal to the plain chain (``sample_moves`` -> ``open_boundary_drop``
-> ``move_codes`` -> ``class_ranks``) in ``dcode``, ``rank_p`` and ``cnt``
at the em_uniform, CARES and LES shapes, at one and four classes, on a 2x2
block of an open domain, with every slot dead and with every slot a mover;
whole coupled steps through K6 bit-equal to the same steps through the
plain chain, with one K6 launch a transport step; and the wrapper refusing
bad inputs.
"""

from types import SimpleNamespace

import pytest
import torch

from wrf_partmc_tpu_torch.models.coupled import transport
from wrf_partmc_tpu_torch.ops import moves
from wrf_partmc_tpu_torch.utils import rng


def _sort_ranks(dcode, D):
    """Each slot's rank among its cell's slots of its class, read off a
    stable sort of the codes (0 where the code is negative), and the counts."""
    C, P = dcode.shape
    order = torch.argsort(dcode, dim=-1, stable=True)
    codes = torch.gather(dcode, 1, order).long()
    first = torch.searchsorted(codes, codes, right=False)     # a group's first position
    rank_sorted = torch.arange(P).expand(C, P) - first
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    rank = torch.where(dcode >= 0, rank, 0)
    cnt = torch.stack([(dcode == d).sum(-1) for d in range(D)], -1)
    return rank, cnt


@pytest.mark.parametrize("P", [128, 1280])
@pytest.mark.parametrize("D", [6, 14, 28])
def test_class_ranks_match_a_stable_sort(D, P):
    g = torch.Generator().manual_seed(D * P)
    dcode = torch.randint(moves.GONE, D, (24, P), generator=g, dtype=torch.int32)
    dcode[0] = moves.STAY                                    # a cell with no mover
    dcode[1] = D - 1                                         # one where every slot moves alike
    rank_p, cnt = moves.class_ranks(dcode, D)
    want_rank, want_cnt = _sort_ranks(dcode, D)
    assert rank_p.dtype == torch.int32 and cnt.dtype == torch.float32
    assert torch.equal(rank_p.long(), want_rank)
    assert torch.equal(cnt, want_cnt.float())
    assert int(cnt[1, -1]) == P and int(cnt[0].sum()) == 0


def _cfg(periodic):
    return SimpleNamespace(boundary=SimpleNamespace(periodic_x=periodic, periodic_y=periodic))


def _inputs(shape, n_class, device, seed=0, n_alive=None, h_scale=0.15):
    """A stand-in state (num, w_class) of ``shape`` slots and random face
    probabilities and row-stochastic R, in the step's shapes."""
    nz, ny, nx, P = shape
    g = torch.Generator(device=device).manual_seed(seed)
    num = torch.rand(shape, generator=g, device=device) * 1e6
    if n_alive is not None:
        num[..., n_alive:] = 0.0
    w_class = torch.randint(0, n_class, shape, generator=g, device=device, dtype=torch.int32)
    ph = [torch.rand((n_class, nz, ny, nx), generator=g, device=device) * h_scale
          for _ in range(4)]
    R = torch.rand((n_class, ny, nx, nz, nz), generator=g, device=device)
    R = R / R.sum(-1, keepdim=True)
    aero = SimpleNamespace(num=num, w_class=w_class, alive=num > 0.0)
    return aero, ph, R


def _plain_chain(aero, ph, R, key, cfg, grid=None):
    """The public chain that ``transport.move_ranks`` replaces."""
    dj, di, dest, horiz = transport.sample_moves(aero, ph, R, key)
    drop = transport.open_boundary_drop(dj, di, horiz, cfg, grid)
    dcode = moves.move_codes(aero.alive, dest, dj, di, horiz, drop)
    return (dcode, *moves.class_ranks(dcode, aero.num.shape[0] + 4))


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_step_front_is_the_plain_chain_on_the_cpu():
    aero, ph, R = _inputs((4, 5, 6, 32), 2, "cpu", n_alive=24, h_scale=0.3)
    key, cfg = rng.key(3), _cfg(False)
    before = dict(transport.K6_COUNTS)
    got = transport.move_ranks(aero, ph, R, key, cfg)
    assert transport.K6_COUNTS == {"steps": before["steps"] + 1, "k6": before["k6"]}
    _same(got, _plain_chain(aero, ph, R, key, cfg))
    dcode = got[0]
    assert (dcode == moves.GONE).any() and (dcode == moves.STAY).any() and (dcode >= 4).any()


def test_kernel_wrapper_refuses_cpu_tensors():
    aero, ph, R = _inputs((2, 3, 3, 8), 1, "cpu")
    u = torch.rand(aero.num.shape)
    with pytest.raises(ValueError, match="one CUDA device"):
        moves.move_ranks_cuda(u, u, aero.num, aero.w_class, ph, R.cumsum(-1),
                              moves.Edges(0, 0, 3, 3, False, False))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (slot shape [nz, ny, nx, P], classes, live slots a cell, periodic,
#  block (offsets, global shape) or None, face-probability scale)
K6_CASES = {
    "em_uniform": ((10, 40, 40, 1280), 1, 1000, True, None, 0.15),
    "cares_open": ((24, 72, 72, 128), 1, 100, False, None, 0.15),
    "les_nz16": ((16, 40, 40, 1280), 1, 1000, True, None, 0.15),
    "four_classes": ((10, 12, 12, 128), 4, 100, True, None, 0.15),
    "four_classes_open": ((10, 12, 12, 130), 4, None, False, None, 0.3),
    "block_2x2_open": ((24, 36, 36, 128), 2, 100, False, ((36, 0), (72, 72)), 0.3),
    "all_dead": ((10, 8, 8, 1280), 1, 0, True, None, 0.15),
    "all_movers": ((10, 8, 8, 1280), 1, None, False, None, 0.25),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_bit_equal_to_the_plain_chain(cuda, case):
    shape, n_class, n_alive, periodic, block, h = K6_CASES[case]
    aero, ph, R = _inputs(shape, n_class, cuda, seed=len(case), n_alive=n_alive, h_scale=h)
    if case == "all_movers":                     # every slot leaves its cell
        ph = [torch.full_like(p, 0.25) for p in ph]
    grid = None if block is None else SimpleNamespace(offsets=block[0], global_shape=block[1])
    key, cfg = rng.key(11), _cfg(periodic)
    before = moves.move_ranks_cuda.launches
    got = transport.move_ranks(aero, ph, R, key, cfg, grid)
    assert moves.move_ranks_cuda.launches == before + 1
    want = _plain_chain(aero, ph, R, key, cfg, grid)
    _same(got, want)
    dcode = got[0]
    if case == "all_dead":
        assert bool((dcode == moves.GONE).all())
    elif case == "all_movers":
        assert not bool((dcode == moves.STAY).any()) and bool((dcode == moves.GONE).any())
    else:
        assert bool((dcode >= 0).any()) and bool((dcode == moves.STAY).any())


def _aero_fields(a):
    return [getattr(a, k) for k in ("vol", "num", "pid", "source", "w_class", "t_create",
                                    "next_id", "src_id", "src_vol", "hyst_leg")]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["em_uniform", "cares"])
def test_coupled_steps_through_k6_bit_equal(cuda, path, monkeypatch):
    """Two coupled steps with K6 against the same two with the plain chain
    patched in, from two builds of one state; one K6 launch a step."""
    from wrf_partmc_tpu_torch.cares import build_cares_shape
    from wrf_partmc_tpu_torch.entry import build

    make = ((lambda: build(12, 12, 4, n_part=24, cap=32, device="cuda")) if path == "em_uniform"
            else (lambda: build_cares_shape(12, 10, 8, n_part=16, cap=32, device="cuda")))
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(transport, "move_ranks", _plain_chain)
        model, state = make()
        before, launched = dict(transport.K6_COUNTS), moves.move_ranks_cuda.launches
        for _ in range(2):
            state = model(state)
        torch.cuda.synchronize()
        runs.append(_aero_fields(state.aero))
        if not plain:
            assert transport.K6_COUNTS["k6"] - before["k6"] == 2
            assert transport.K6_COUNTS["steps"] - before["steps"] == 2
            assert moves.move_ranks_cuda.launches - launched == 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_k6_wrapper_refuses_bad_inputs(cuda):
    aero, ph, R = _inputs((4, 6, 6, 64), 2, cuda)
    u = torch.rand(aero.num.shape, device=cuda)
    R_cum = R.cumsum(-1)
    edges = moves.Edges(0, 0, 6, 6, False, False)
    run = moves.move_ranks_cuda
    with pytest.raises(ValueError, match="float32"):
        run(u.double(), u, aero.num, aero.w_class, ph, R_cum, edges)
    with pytest.raises(ValueError, match="int32"):
        run(u, u, aero.num, aero.w_class.long(), ph, R_cum, edges)
    with pytest.raises(ValueError, match="one \\[nz, ny, nx, P\\] shape"):
        run(u, u[..., :32].contiguous(), aero.num, aero.w_class, ph, R_cum, edges)
    with pytest.raises(ValueError, match="R rows"):
        run(u, u, aero.num, aero.w_class, ph, R_cum[:1].contiguous(), edges)
    with pytest.raises(ValueError, match="R rows"):
        run(u, u, aero.num, aero.w_class, ph[:3], R_cum, edges)
    with pytest.raises(ValueError, match="contiguous"):
        run(u, u, aero.num, aero.w_class, [p.transpose(-1, -2) for p in ph], R_cum, edges)
    with pytest.raises(ValueError, match="one CUDA device"):
        run(u, u, aero.num.cpu(), aero.w_class, ph, R_cum, edges)
