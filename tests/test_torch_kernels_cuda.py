"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Skipped where there is no CUDA device (the CPU tests hold the
plain versions against the JAX package instead).

    python -m pytest tests/test_torch_kernels_cuda.py -m gpu

K2/K3 are copies and must be bit-exact, at every layout their launch plan
takes (whole cells in groups, channel tiles, bulk-copied and plainly
loaded tiles).  K1 performs the plain recurrence's float32 operations in
its order without FMA contraction, so it too must be bit-exact, at every
level bucket (registers for n <= 32, the shared-memory window above, and
a column longer than one window) and for several strided fields per
launch.  Outputs are allocated over NaN junk, so a slot a kernel misses
shows.  K4 (threefry draws) must give its plain version's bits in every
mode, flat and as every (2, 2) block of the em_uniform and CARES draws.
K5 (bulk optics of the fitted Mie surrogate) sums the 900-term series and
the cells in another order than its plain version: each of its sums is
held within 2e-5 of its cell's extinction sum (``_k5_close``) on
populations of the path's sizes and indices, and within 2e-3 over and
beyond the fit's whole domain (see ``_k5_inputs``).
"""

import dataclasses

import pytest
import torch

from wrf_partmc_tpu_torch.models.partmc import mie, optics
from wrf_partmc_tpu_torch.models.partmc.aero_data import make_aero_data
from wrf_partmc_tpu_torch.models.partmc.aero_state import zero_state
from wrf_partmc_tpu_torch.ops import mie_fit, place, threefry, tridiag
from wrf_partmc_tpu_torch.parallel.mesh import Mesh
from wrf_partmc_tpu_torch.utils import rng
from wrf_partmc_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cshape,bshape", [((9, 40, 40), (9, 40, 40)),
                                           ((10, 1, 40, 40), (10, 3, 40, 40)),
                                           ((8, 1, 1), (8, 5, 7))])
def test_thomas_kernel_matches_plain(cuda, cshape, bshape):
    g = torch.Generator(device=cuda).manual_seed(0)
    dl = torch.randn(cshape, generator=g, device=cuda)
    du = torch.randn(cshape, generator=g, device=cuda)
    d = 4.0 + torch.randn(cshape, generator=g, device=cuda).abs()
    b = torch.randn(bshape, generator=g, device=cuda)
    before = tridiag.thomas_solve.launches
    x = tridiag.solve(dl, d, du, b)
    assert tridiag.thomas_solve.launches == before + 1
    ref = tridiag.solve_scan(dl, d, du, b)
    torch.testing.assert_close(x, ref, rtol=1e-6, atol=1e-7)


def _system(g, cshape, cuda):
    dl = torch.randn(cshape, generator=g, device=cuda)
    du = torch.randn(cshape, generator=g, device=cuda)
    d = 4.0 + torch.randn(cshape, generator=g, device=cuda).abs()
    return dl, d, du


# the levels of every path (4 Noah, 9/10 em_uniform, 15/16 LES, 23/24
# CARES), the bucket edges, the full CARES grid's 65 and a column longer
# than one shared-memory window (96 levels)
LEVELS = [1, 2, 4, 9, 10, 15, 16, 17, 23, 24, 25, 32, 33, 65, 200]


@pytest.mark.parametrize("n", LEVELS)
@pytest.mark.parametrize("broadcast", [False, True])
def test_thomas_kernel_bit_exact(cuda, n, broadcast):
    """[n, ny, nx] coefficients, or [n, 1, ny, nx] against [n, L, ny, nx]."""
    g = torch.Generator(device=cuda).manual_seed(n)
    cshape, bshape = ((n, 1, 9, 13), (n, 5, 9, 13)) if broadcast else ((n, 9, 13),) * 2
    dl, d, du = _system(g, cshape, cuda)
    b = torch.randn(bshape, generator=g, device=cuda)
    _junk_then_empty(bshape, cuda)
    before = tridiag.thomas_solve.launches
    x = tridiag.solve(dl, d, du, b)
    assert tridiag.thomas_solve.launches == before + 1
    assert torch.equal(x, tridiag.solve_scan(dl, d, du, b))


# (n, field shapes): one field; vertical diffusion's six at the em_uniform,
# mesoscale-options (WSM5's 5 moist), LES and CARES levels; eight of mixed
# L with a transposed stack and a level-sliced view, at a register bucket
# and at the window
FIELDS = [(10, ["3"]),
          (10, ["1", "1", "1", "3", "32", "1"]),
          (10, ["1", "1", "1", "5", "32", "1"]),
          (16, ["1", "1", "1", "3", "32", "1"]),
          (24, ["1", "1", "1", "10", "77", "1"]),
          (9, ["1", "2", "T3", "S", "5", "1", "4", "1"]),
          (65, ["1", "2", "T3", "S", "5", "1", "4", "1"])]


def _field(g, kind, n, cols, cuda):
    if kind == "T3":
        return torch.randn((n, 3, *cols), generator=g, device=cuda).transpose(0, 1)
    if kind == "S":
        return torch.randn((n + 2, *cols), generator=g, device=cuda)[1:n + 1]
    L = int(kind)
    shape = (n, *cols) if L == 1 else (L, n, *cols)
    return torch.randn(shape, generator=g, device=cuda)


@pytest.mark.parametrize("n,kinds", FIELDS)
def test_solve_fields_bit_exact(cuda, n, kinds):
    g = torch.Generator(device=cuda).manual_seed(len(kinds))
    cols = (9, 13)
    dl, d, du = _system(g, (n, *cols), cuda)
    fields = [_field(g, k, n, cols, cuda) for k in kinds]
    for f in fields:
        _junk_then_empty(f.shape, cuda)
    before = tridiag.thomas_solve.launches
    xs = tridiag.solve_fields(dl, d, du, fields)
    assert tridiag.thomas_solve.launches == before + 1
    for x, ref in zip(xs, tridiag.solve_fields_scan(dl, d, du, fields)):
        assert x.is_contiguous() and torch.equal(x, ref)


# the shapes the decomposed paths give K1 on a 2x2 mesh: the ARW acoustic
# solve and vertical diffusion's six fields on the [*, 20, 20] blocks of the
# main path's 40x40x10, MYJ, Noah and vertical diffusion (10 moist, 77
# gases) on the [*, 36, 36] blocks of the CARES shape's 72x72x24
BLOCK_SHAPES = [(9, (20, 20), ["1"]),
                (10, (20, 20), ["1", "1", "1", "3", "32", "1"]),
                (23, (36, 36), ["1"]),
                (4, (36, 36), ["1"]),
                (24, (36, 36), ["1", "1", "1", "10", "77", "1"])]


@pytest.mark.parametrize("n,cols,kinds", BLOCK_SHAPES)
def test_thomas_block_shapes_bit_exact(cuda, n, cols, kinds):
    g = torch.Generator(device=cuda).manual_seed(n)
    dl, d, du = _system(g, (n, *cols), cuda)
    fields = [_field(g, k, n, cols, cuda) for k in kinds]
    for f in fields:
        _junk_then_empty(f.shape, cuda)
    before = tridiag.thomas_solve.launches
    xs = tridiag.solve_fields(dl, d, du, fields)
    assert tridiag.thomas_solve.launches == before + 1
    for x, ref in zip(xs, tridiag.solve_fields_scan(dl, d, du, fields)):
        assert torch.equal(x, ref)


def _unique_dst(g, B, L1, L2, drop, cuda):
    n = min(L1, L2)
    perm = torch.argsort(torch.rand((B, L2), generator=g, device=cuda), dim=1)[:, :n]
    dst = torch.full((B, L1), -1, dtype=torch.int32, device=cuda)
    dst[:, :n] = perm.to(torch.int32)
    dst[torch.rand((B, L1), generator=g, device=cuda) < drop] = -1
    return dst


def _junk_then_empty(shape, cuda):
    """Leave NaNs in the caching allocator's next block of this size, so an
    output slot the kernel fails to write shows."""
    junk = torch.full(shape, float("nan"), device=cuda)
    del junk


# (B, CH, L1, L2): the path shapes (chem-off T1 1280->1120 and T2 400->400,
# CARES T1 128->448 and T2 80->80) at few cells; channel tiles that do not
# divide 33 (T1's output row is larger than one block's tile); L2 much
# larger than L1 and the reverse; L not a multiple of 4 (the unaligned
# store path), with and without channel tiles; groups of cells with a
# partial last group; one cell; more than 65,535 cells
SCATTER = [(64, 33, 1280, 1120), (64, 33, 400, 400), (7, 5, 48, 128), (70000, 3, 40, 40),
           (5, 33, 128, 448), (5, 33, 448, 128), (9, 33, 80, 80), (1, 33, 1280, 1120),
           (6, 13, 10, 10), (4, 33, 1283, 1121), (3, 37, 1282, 1282), (70001, 33, 80, 80)]


@pytest.mark.parametrize("B,CH,L1,L2", SCATTER)
def test_scatter_kernel_bit_exact(cuda, B, CH, L1, L2):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((B, CH, L1), generator=g, device=cuda)
    dst = _unique_dst(g, B, L1, L2, 0.1, cuda)
    _junk_then_empty((B, CH, L2), cuda)
    before = place.scatter_rows_cuda.launches
    out = place.scatter_rows(x, dst, L2)
    assert place.scatter_rows_cuda.launches == before + 1
    assert torch.equal(out, place.scatter_rows_plain(x, dst, L2))


@pytest.mark.parametrize("B,CH,L1,L2", [(16, 33, 1280, 1120), (9, 33, 80, 80), (6, 13, 10, 10)])
def test_scatter_kernel_dropped_and_out_of_range(cuda, B, CH, L1, L2):
    """Rows whose dst are all -1 (whole warps and whole cells) and dst
    outside [0, L2) drop; the output is zero there, not what the allocator
    held."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((B, CH, L1), generator=g, device=cuda)
    dst = _unique_dst(g, B, L1, L2, 0.5, cuda)
    dst[0] = -1                                     # a cell with no mover
    dst[1, : min(L1, 64)] = -1                      # whole warps dropped
    bad = torch.rand((B, L1), generator=g, device=cuda) < 0.1
    far = torch.randint(L2, 2 * L2 + 3, (B, L1), generator=g, device=cuda, dtype=torch.int32)
    dst = torch.where(bad, torch.where(far % 2 == 0, far, -far), dst).contiguous()
    _junk_then_empty((B, CH, L2), cuda)
    out = place.scatter_rows(x, dst, L2)
    assert torch.equal(out, place.scatter_rows_plain(x, dst, L2))
    assert not bool(out[0].any())


# the path shapes (chem-off T2 400->1280 and coagulation 1280->1280, CARES
# T2 80->128 and coagulation 128->128) at few cells, and the cases above;
# L1 = 1282 mixes bulk-copied and plainly loaded channel tiles in one block
GATHER = [(64, 33, 400, 1280), (64, 33, 1280, 1280), (7, 5, 48, 16), (70000, 3, 40, 40),
          (9, 33, 80, 128), (5, 33, 128, 128), (1, 33, 1280, 1280), (5, 33, 448, 128),
          (5, 33, 128, 448), (6, 13, 10, 10), (4, 33, 1283, 1121), (3, 33, 1282, 640),
          (70001, 33, 80, 128)]


@pytest.mark.parametrize("B,CH,L1,L2", GATHER)
def test_gather_kernel_bit_exact(cuda, B, CH, L1, L2):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((B, CH, L1), generator=g, device=cuda)
    src = torch.randint(-1, L1, (B, L2), generator=g, device=cuda, dtype=torch.int32)
    before = place.gather_rows_cuda.launches
    out = place.gather_rows(x, src)
    assert place.gather_rows_cuda.launches == before + 1
    assert torch.equal(out, place.gather_rows_plain(x, src))


@pytest.mark.parametrize("B,CH,L1,L2", [(16, 33, 1280, 1280), (9, 33, 80, 128), (6, 13, 10, 10)])
def test_gather_kernel_empty_and_out_of_range(cuda, B, CH, L1, L2):
    """A cell whose src are all -1 gives zeros; src outside [0, L1) gives a
    zero row; a payload that is a misaligned view takes the plain loads."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((B, CH, L1), generator=g, device=cuda)
    src = torch.randint(-1, L1, (B, L2), generator=g, device=cuda, dtype=torch.int32)
    src[0] = -1
    bad = torch.rand((B, L2), generator=g, device=cuda) < 0.1
    far = torch.randint(L1, 2 * L1 + 3, (B, L2), generator=g, device=cuda, dtype=torch.int32)
    src = torch.where(bad, torch.where(far % 2 == 0, far, -far), src).contiguous()
    out = place.gather_rows(x, src)
    assert torch.equal(out, place.gather_rows_plain(x, src))
    assert not bool(out[0].any())
    flat = torch.randn(B * CH * L1 + 1, generator=g, device=cuda)
    xs = flat[1:].view(B, CH, L1)                   # 4 bytes past a 16-byte boundary
    assert torch.equal(place.gather_rows(xs, src), place.gather_rows_plain(xs, src))


def test_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 3, 8), device=cuda)
    with pytest.raises(ValueError):
        place.scatter_rows_cuda(x, torch.zeros((2, 8), dtype=torch.int64, device=cuda), 8)
    with pytest.raises(ValueError):
        place.gather_rows_cuda(x.transpose(1, 2), torch.zeros((2, 3), dtype=torch.int32,
                                                              device=cuda))
    with pytest.raises(ValueError):
        w = torch.ones((4, 3), dtype=torch.float64, device=cuda)
        tridiag.thomas_solve(w, w, w, [w])
    c = torch.ones((4, 3), device=cuda)
    with pytest.raises(ValueError):
        tridiag.thomas_solve(c, c, c, [c] * (tridiag.MAX_FIELDS + 1))
    with pytest.raises(ValueError):
        tridiag.thomas_solve(c, c, c, [c, torch.ones((4, 3))])
    with pytest.raises(ValueError):
        tridiag.thomas_solve(c, c, c, [torch.ones((3, 4), device=cuda).t()])


def _fragmented_state(g, cells, S, P, cuda):
    """A population with a third of its slots dead, scattered."""
    from wrf_partmc_tpu_torch.models.partmc.aero_data import make_aero_data
    from wrf_partmc_tpu_torch.models.partmc.aero_state import zero_state

    st = zero_state(make_aero_data(device=cuda), P, cells, device=cuda)
    alive = torch.rand((*cells, P), generator=g, device=cuda) > 0.33
    num = torch.where(alive, torch.rand((*cells, P), generator=g, device=cuda) * 1e8, 0.0)
    vol = torch.where(alive[..., None, :],
                      torch.rand((*cells, S, P), generator=g, device=cuda) * 1e-21, 0.0)
    pid = torch.where(alive, torch.arange(P, dtype=torch.int32, device=cuda), 0)
    return dataclasses.replace(st, num=num, vol=vol, pid=pid,
                               t_create=torch.rand((*cells, P), generator=g, device=cuda))


@pytest.mark.parametrize("cells,P", [((10, 4, 4), 1280), ((1, 1, 1), 2048), ((3, 5, 7), 33)])
def test_compact_through_scatter_kernel_bit_exact(cuda, cells, P):
    """``aero_state.compact`` launches K2 once and equals the plain scatter
    through the same pack and unpack, field for field (the real-data
    path's [16000, 33, 1280] and the box's one cell at the few-cell
    scale)."""
    from wrf_partmc_tpu_torch.models.partmc import aero_state

    g = torch.Generator(device=cuda).manual_seed(5)
    st = _fragmented_state(g, cells, 20, P, cuda)
    before = place.scatter_rows_cuda.launches
    out = aero_state.compact(st)
    assert place.scatter_rows_cuda.launches == before + 1
    alive = st.alive
    rank = torch.cumsum(alive.to(torch.int32), dim=-1) - 1
    dst = torch.where(alive, rank, -1).reshape(-1, P).to(torch.int32).contiguous()
    ref = aero_state.unpack_payload(st, place.scatter_rows_plain(aero_state.pack_payload(st),
                                                                  dst, P))
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(out, f.name), getattr(ref, f.name)), f.name
    n = alive.sum(-1)
    assert torch.equal(out.alive, torch.arange(P, device=cuda) < n[..., None])


@pytest.mark.parametrize("L1,L2", [(2048, 2048), (2048, 1024), (1024, 2048), (2047, 2049)])
def test_gather_kernel_one_box_bit_exact(cuda, L1, L2):
    """K3 at B = 1, the box model's shapes (one cell of 2048 slots, 33
    channels: the coagulation pairing and the rebalance's split)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((1, 33, L1), generator=g, device=cuda)
    src = torch.randint(-1, L1, (1, L2), generator=g, device=cuda, dtype=torch.int32)
    _junk_then_empty((1, 33, L2), cuda)
    before = place.gather_rows_cuda.launches
    out = place.gather_rows(x, src)
    assert place.gather_rows_cuda.launches == before + 1
    assert torch.equal(out, place.gather_rows_plain(x, src))


@pytest.mark.parametrize("shape", [(9, 40, 40), (3, 12, 12)])
def test_linear_acoustic_k1_bit_exact(cuda, shape):
    """K1 at the linear core's w-p solve: [nz-1, 1, 1] diagonals against a
    [nz-1, ny, nx] right-hand side (the em_uniform and the test widths)."""
    g = torch.Generator(device=cuda).manual_seed(shape[0])
    dl, d, du = _system(g, (shape[0], 1, 1), cuda)
    b = torch.randn(shape, generator=g, device=cuda)
    _junk_then_empty(shape, cuda)
    before = tridiag.thomas_solve.launches
    x = tridiag.solve(dl, d, du, b)
    assert tridiag.thomas_solve.launches == before + 1
    assert torch.equal(x, tridiag.solve_scan(dl, d, du, b))


def _step_close(out, ref):
    """A step on the card against the CPU's: every dycore field rtol 1e-4
    with a floor of 1e-4 of its scale (1e-5 m/s for w, 1e-3 for ph), the
    per-cell represented number rtol 1e-4."""
    for f in dataclasses.fields(ref.dyn):
        a, b = getattr(out.dyn, f.name), getattr(ref.dyn, f.name)
        if b is None:
            assert a is None, f.name
            continue
        atol = max({"w": 1e-5, "ph": 1e-3}.get(f.name, 0.0), 1e-4 * float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=f.name)
    torch.testing.assert_close(out.aero.total_num(), ref.aero.total_num(), rtol=1e-4, atol=0.0)


def test_linear_coupled_step_launches_k1(cuda):
    """One linear-core coupled step on the card: K1 1 + 2 + 4 times in the
    acoustic substeps (n_sound = 4) and once in vertical diffusion, and the
    step agrees with the CPU's."""
    from wrf_partmc_tpu_torch.entry import build

    model, state = build(12, 12, 4, n_part=16, cap=48, dyn_opt="linear", device="cpu")
    ref = model(state)
    before = tridiag.thomas_solve.launches
    out = model.to(cuda)(state.to(cuda))
    torch.cuda.synchronize()
    assert tridiag.thomas_solve.launches - before == 7 + 1
    _step_close(out.to("cpu"), ref)


def test_world_of_one_nccl_step(cuda, tmp_path):
    """A decomposed step in a world of one over NCCL on the card against a
    world of one over gloo on the CPU (the 1x1 mesh: each rank's block is
    the domain, so the dycore blocks are compared whole), and the card's
    decomposed dycore against its undecomposed step, bit for bit (the
    halos of a 1x1 mesh are local copies)."""
    from wrf_partmc_tpu_torch.entry import build
    from wrf_partmc_tpu_torch.parallel import distributed as pdist

    outs = {}
    for dev in ("cuda", "cpu"):
        pdist.init(f"file://{tmp_path}/rdv-{dev}", 1, 0, dev, timeout_s=120)
        try:
            mesh = pdist.global_mesh()
            assert mesh.device.type == dev and mesh.shape == (1, 1)
            model, state = build(12, 12, 4, n_part=16, cap=48, device=mesh.device, mesh=mesh)
            assert model.grid.mesh == mesh and (model.grid.ny, model.grid.nx) == (12, 12)
            outs[dev] = model(state).to("cpu")
        finally:
            pdist.shutdown()
    _step_close(outs["cuda"], outs["cpu"])
    model, state = build(12, 12, 4, n_part=16, cap=48, device=cuda)
    plain = model(state).to("cpu")
    for f in dataclasses.fields(plain.dyn):
        a, b = getattr(outs["cuda"].dyn, f.name), getattr(plain.dyn, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


# K4: the draws' float32 range (lo, span) by mode; "gumbel" is the uniform
# on (tiny, 1) that gumbel and categorical draw
K4_RANGES = {"bits": (0.0, 1.0), "uniform": (0.0, 1.0),
             "gumbel": rng._lo_span(float(torch.finfo(torch.float32).tiny), 1.0),
             "normal": (rng.NORMAL_LO, rng.NORMAL_SPAN)}
K4_SEEDS = [0, 1, 12345, 2 ** 31 - 1]


def _k4(mode, k, shape, device, block=None):
    """K4's draw and the plain version's, for mode in K4_RANGES."""
    kernel_mode = "uniform" if mode == "gumbel" else mode
    lo, span = K4_RANGES[mode]
    before = threefry.threefry_draw.launches
    got = threefry.threefry_draw(kernel_mode, k, shape, device, lo, span,
                                 None if block is None else block.kernel_args(shape))
    assert threefry.threefry_draw.launches == before + 1
    return got, rng.draw_plain(kernel_mode, k, shape, device, lo, span, block)


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


# the particle draws of em_uniform and CARES, their transport arrivals and a
# ragged 1-D size
@pytest.mark.parametrize("shape", [(16000, 1280), (31104, 128), (1_000_003,)], ids=str)
@pytest.mark.parametrize("seed", K4_SEEDS)
@pytest.mark.parametrize("mode", list(K4_RANGES))
def test_threefry_kernel_bit_exact(cuda, mode, seed, shape):
    _junk_then_empty(shape, cuda)
    _same_bits(*_k4(mode, rng.fold_in(rng.key(seed), 7), shape, cuda))


@pytest.mark.parametrize("shape", [(10, 40, 40, 1280), (24, 72, 72, 128), (24, 72, 72)],
                         ids=str)
@pytest.mark.parametrize("seed", K4_SEEDS)
@pytest.mark.parametrize("mode", ["bits", "uniform", "normal"])
def test_threefry_kernel_blocks_bit_exact(cuda, mode, seed, shape):
    """Every (2, 2) block of a global draw, through K4, equals the slice of
    the plain global draw and the plain block draw."""
    k = rng.key(seed)
    whole = rng.draw_plain(mode, k, shape, cuda, *K4_RANGES[mode])
    ny, nx = shape[1:3]
    for r in range(4):
        mesh = Mesh((2, 2), r, cuda)
        b = mesh.draw_block(ny, nx)
        rows, cols = mesh.slices(ny, nx)
        got, plain = _k4(mode, k, (shape[0], b.ny_l, b.nx_l, *shape[3:]), cuda, b)
        _same_bits(got, plain)
        _same_bits(got, whole[:, rows, cols].contiguous())


def test_rng_draws_launch_k4(cuda):
    """``rng``'s draws on the card go through K4, one launch each, and give
    the CPU's draws; randint's modulo stays in torch."""
    k, shape = rng.key(3), (40, 33)
    calls = {"random_bits": lambda d: rng.random_bits(k, shape, d),
             "uniform": lambda d: rng.uniform(k, shape, d, -2.0, 5.0),
             "normal": lambda d: rng.normal(k, shape, d),
             "randint": lambda d: rng.randint(k, shape, d, -7, 1000)}
    for name, draw in calls.items():
        before = threefry.threefry_draw.launches
        got = draw(cuda)
        assert threefry.threefry_draw.launches == before + (2 if name == "randint" else 1)
        _same_bits(got.cpu(), draw("cpu"))


# K5: the fitted Mie surrogate's bulk sums
def _k5_inputs(C, P, device, seed=0, wide=False):
    """diam, n, k, live number [C, P]: diameters 1 nm to 10 um, n 1.33-1.82
    and k 0 or 1e-3 to 0.74 (the species' indices), or with ``wide`` x
    from 1e-4 to 1e3, n 1.0-2.2 and k 0, 1 or 1e-5 to 1, where the fit's
    corners reach log10 q of +-30 and float32 900-term sums in two orders
    differ by ~1e-4 of log10 q; dead slots and an empty first cell."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((C, P), generator=g, device=device)
    coin = lambda p: torch.rand((C, P), generator=g, device=device) < p
    if wide:
        diam = 10.0 ** u(-11.0, -3.5)
        n = u(1.0, 2.2)
        k = torch.where(coin(0.25), 0.0, torch.where(coin(0.3), 1.0, 10.0 ** u(-5.0, 0.0)))
    else:
        diam = 10.0 ** u(-9.0, -5.0)
        n = u(1.33, 1.82)
        k = torch.where(coin(0.3), 0.0, 10.0 ** u(-3.0, -0.13))
    num = torch.where(coin(0.8), u(1e6, 1e8), 0.0)
    num[0] = 0.0
    return diam, n, k, num


def _k5_close(got, want, rtol):
    """Two [3, W, C] sums: each within ``rtol`` of its cell's extinction sum
    (c_sca + c_abs) num with a floor of 1e-6 of the largest, and so the
    extinction to ``rtol`` of itself.  Not each sum of itself: q_sca =
    q_ext - q_abs cancels for small absorbing particles, so the last ulps of
    q_ext move c_sca and c_abs by a share of c_ext; this bounds waer's
    error by about 2 ``rtol``."""
    got, want = got.double(), want.double()
    ext = want[0] + want[1]
    lim = rtol * ext + 1e-6 * float(ext.max())
    for q in range(3):
        err = (got[q] - want[q]).abs()
        assert bool((err <= lim).all()), (q, float((err / lim.clamp(min=1e-300)).max()))


def _k5(diam, n, k, num, wavelengths=optics.WAVELENGTHS):
    before = mie_fit.mie_fit_bulk.launches
    got = mie_fit.mie_fit_bulk(diam, n, k, num, mie._fit_coeffs(diam.device), wavelengths)
    assert mie_fit.mie_fit_bulk.launches == before + 1
    return got


# the CARES block, the CARES card-vs-CPU step, one slot, a ragged warp and
# more slots than a block has threads
@pytest.mark.parametrize("C,P", [(24 * 36 * 36, 128), (960, 32), (7, 1), (5, 33), (3, 300)])
def test_mie_fit_kernel_matches_plain(cuda, C, P):
    ins = _k5_inputs(C, P, cuda)
    got = _k5(*ins)
    assert got.shape == (3, 4, C)
    assert bool((got[:, :, 0] == 0.0).all())
    _k5_close(got, optics.mie_fit_sums_plain(*ins), 2e-5)


@pytest.mark.parametrize("bands", [1, 3])
def test_mie_fit_kernel_fewer_bands(cuda, bands):
    ins = _k5_inputs(50, 128, cuda, seed=1)
    wl = optics.WAVELENGTHS[:bands]
    got = _k5(*ins, wavelengths=wl)
    assert got.shape == (3, bands, 50)
    _k5_close(got, optics.mie_fit_sums_plain(*ins, wavelengths=wl), 2e-5)


def test_mie_fit_kernel_whole_domain(cuda):
    ins = _k5_inputs(200, 64, cuda, seed=2, wide=True)
    _k5_close(_k5(*ins), optics.mie_fit_sums_plain(*ins), 2e-3)


def test_bulk_optical_props_launches_k5_once(cuda):
    """``bulk_optical_props`` on the card launches K5 once and gives the
    CPU's fields (plain version) at rtol 2e-5, floor 1e-6 of the scale."""
    cells, P = (3, 4, 5), 32
    ad = make_aero_data()
    S = ad.n_spec
    g = torch.Generator().manual_seed(4)
    frac = torch.rand((*cells, S, P), generator=g) * (torch.rand((*cells, S, P), generator=g) < 0.4)
    frac[..., ad.spec_by_name("BC"), :] += 0.2
    frac = frac / frac.sum(-2, keepdim=True)
    v = torch.pi / 6 * (10.0 ** (-7.7 + 2.0 * torch.rand((*cells, P), generator=g))) ** 3
    num = torch.where(torch.rand((*cells, P), generator=g) < 0.85,
                      1e15 + 1e17 * torch.rand((*cells, P), generator=g), 0.0)
    st = dataclasses.replace(zero_state(ad, P, cells), vol=frac * v[..., None, :] * (num > 0)[..., None, :],
                             num=num)
    dz = torch.tensor([60.0, 90.0, 140.0])
    V = 4000.0 * 4000.0 * dz.reshape(-1, 1, 1) * torch.ones(cells)
    ref = optics.bulk_optical_props(st, ad, dz, V)
    before = mie_fit.mie_fit_bulk.launches
    out = optics.bulk_optical_props(tree_map(lambda t: t.to(cuda), st),
                                    make_aero_data(device=cuda), dz.to(cuda), V.to(cuda))
    assert mie_fit.mie_fit_bulk.launches == before + 1
    for name in ("tauaer", "waer", "gaer"):
        want = getattr(ref, name)
        torch.testing.assert_close(getattr(out, name).cpu(), want, rtol=2e-5,
                                   atol=1e-6 * float(want.abs().max()), msg=name)


def test_mie_fit_wrapper_refuses_bad_inputs(cuda):
    ins = _k5_inputs(4, 8, cuda)
    coeffs = mie._fit_coeffs(cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mie_fit.mie_fit_bulk(ins[0].cpu(), *ins[1:], coeffs, optics.WAVELENGTHS)
    with pytest.raises(ValueError, match="contiguous float32"):
        mie_fit.mie_fit_bulk(ins[0].t(), *ins[1:], coeffs, optics.WAVELENGTHS)
    with pytest.raises(ValueError, match=r"\[C, P\]"):
        mie_fit.mie_fit_bulk(ins[0][:3], *ins[1:], coeffs, optics.WAVELENGTHS)
    with pytest.raises(ValueError, match="wavelengths"):
        mie_fit.mie_fit_bulk(*ins, coeffs, ())
