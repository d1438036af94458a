"""The port's decomposition layer (``wrf_partmc_tpu_torch/parallel/``) on 4
gloo processes against the JAX package's ``parallel/`` on a (2, 2) mesh of
the conftest's virtual CPU devices.

Four ranks (``parallel.launch.spawn``, a time limit that kills every rank)
each take their block of a numpy field made from a seed and run
``halo.exchange_2d`` (h = 2; periodic and clamped), ``neighbor_shift``
(one way, periodic and open, and the round trip), ``gather_field``,
``host_to_global``/``global_to_host`` and block draws of ``rng.uniform``/
``normal``/``randint``; the JAX package runs ``halo.exchange_2d`` and
``neighbor_shift`` under ``shard_map`` and the global ``jax.random``
draws.  The ranks also run the block stencils of ``ops.stencil`` inside
``decomposed``: ``shift`` by -3..3 and ``make_taps`` of widths 1-3 on the
y and x axes, periodic and clamped, against the whole-domain ``shift``
(``torch.roll``, or the clamped edge) sliced to the block; an extent-1
axis (a (1, 1) mesh in this process, no process group) is the local
copy.  Every comparison is exact: the layer only moves data, and a block
draw hashes the same counters as the global draw.  Also: ``factor_2d``,
the errors of ``make_mesh``/``Mesh``/``shard_field``, a ``cuda`` world on a
host without a card, and the launcher's exit codes and time limit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from wrf_partmc_tpu.parallel import halo as jhalo
from wrf_partmc_tpu.parallel.mesh import factor_2d as jax_factor_2d
from wrf_partmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_partmc_tpu_torch.ops import stencil
from wrf_partmc_tpu_torch.parallel import distributed as pdist, halo
from wrf_partmc_tpu_torch.parallel.launch import free_port, spawn
from wrf_partmc_tpu_torch.parallel.mesh import Mesh, factor_2d, make_mesh, shard_field
from wrf_partmc_tpu_torch.utils import rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120.0
SHAPE = (3, 8, 12)           # [nz, ny, nx]: (2, 2) blocks of 4 x 6
DRAW = (3, 8, 12, 5)         # a cell draw with a trailing axis
H = 2

_RANK = """
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from wrf_partmc_tpu_torch.parallel import distributed as pdist, halo
from wrf_partmc_tpu_torch.parallel.mesh import shard_field
from wrf_partmc_tpu_torch.ops import stencil
from wrf_partmc_tpu_torch.utils import rng
assert pdist.init_from_env("cpu", timeout_s={timeout})
mesh = pdist.global_mesh()
x = np.random.default_rng(0).standard_normal({shape}).astype(np.float32)
blk = pdist.host_to_global(np.ascontiguousarray(x[:, mesh.slices(*{shape}[1:])[0],
                                                   mesh.slices(*{shape}[1:])[1]]), mesh)
assert torch.equal(blk, shard_field(torch.tensor(x), mesh))
halo.reset_counts()
out = dict(
    halo_periodic=halo.exchange_2d(blk, {h}, mesh, periodic=(True, True)),
    halo_clamped=halo.exchange_2d(blk, {h}, mesh, periodic=(False, False)),
    shift_x=halo.neighbor_shift(blk, 1, mesh, "x"),
    shift_y_open=halo.neighbor_shift(blk, 1, mesh, "y", periodic=False),
    round_trip=halo.neighbor_shift(halo.neighbor_shift(blk, 1, mesh, "x"), -1, mesh, "x"),
    whole=pdist.gather_field(blk, mesh),
    host=pdist.global_to_host(blk),
    counts=halo.read_counts())
halo.reset_counts()
with stencil.decomposed(mesh, blk.shape[1:]):
    out["stencil"] = {{(bc, ax, s): stencil.shift(blk, s, ax, bc)
                      for bc in stencil.BCS for ax in (-2, -1) for s in range(-3, 4)}}
    taps = {{(bc, ax, w): stencil.make_taps(blk, -w, w, ax, bc)
            for bc in stencil.BCS for ax in (-2, -1) for w in (1, 2, 3)}}
    out["taps"] = {{k: torch.stack([t(s) for s in range(-k[2], k[2] + 1)])
                   for k, t in taps.items()}}
out["stencil_counts"] = halo.read_counts()
key, b = rng.key(5), mesh.draw_block(*{draw}[1:3])
local = ({draw}[0], b.ny_l, b.nx_l, {draw}[3])
out.update(uniform=rng.uniform(key, local, "cpu", block=b),
           normal=rng.normal(key, local, "cpu", block=b),
           randint=rng.randint(key, local, "cpu", -7, 1000, block=b))
torch.save(out, {path!r} + f".{{mesh.rank}}")
pdist.shutdown()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("parallel") / "out.pt")
    code = _RANK.format(repo=REPO, timeout=TIMEOUT_S, shape=SHAPE, h=H, draw=DRAW,
                        path=path)
    results = spawn(4, [sys.executable, "-c", code], TIMEOUT_S, cwd=REPO)
    for r, (code_r, out) in enumerate(results):
        assert code_r == 0, f"rank {r} exited {code_r}:\n{out[-3000:]}"
    return [torch.load(f"{path}.{r}", weights_only=False) for r in range(4)]


def _field():
    return np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)


def _jax_blocks(fn, pad: int = 0):
    """Run ``fn`` under shard_map on the (2, 2) virtual-device mesh and
    split its result into the four ranks' blocks (rank = 2 iy + ix)."""
    mesh = jax_make_mesh(jax.devices()[:4], shape=(2, 2))
    out = np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(None, "y", "x"),
                                           out_specs=P(None, "y", "x")))(
        jnp.asarray(_field())))
    ly, lx = SHAPE[1] // 2 + 2 * pad, SHAPE[2] // 2 + 2 * pad
    return [out[:, iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx]
            for iy in range(2) for ix in range(2)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_factor_2d(n):
    assert factor_2d(n) == jax_factor_2d(n)


def test_mesh_errors():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
    m = Mesh(shape=(2, 2), rank=3, device=torch.device("cpu"))
    assert (m.iy, m.ix) == (1, 1) and m.rank_at(2, -1) == 1
    with pytest.raises(ValueError, match="does not divide"):
        m.block_shape(7, 8)
    with pytest.raises(ValueError, match="are not the"):
        shard_field(torch.zeros(3, 8, 8), m, 8, 12)
    assert shard_field(torch.arange(64.0).reshape(8, 8), m)[0, 0] == 36.0
    pdist.init(f"127.0.0.1:{free_port()}", 1, 0, "cpu", timeout_s=TIMEOUT_S)
    try:
        with pytest.raises(ValueError, match="!= 1 ranks"):
            make_mesh((2, 2))
        assert make_mesh().shape == (1, 1)
    finally:
        pdist.shutdown()


def test_cuda_world_refuses_without_a_card(monkeypatch):
    """A ``cuda`` world never falls back to gloo or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdist.init(f"127.0.0.1:{free_port()}", 1, 0, "cuda", timeout_s=5)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("periodic", [True, False])
def test_exchange_2d(ranks, periodic):
    ref = _jax_blocks(lambda b: jhalo.exchange_2d(b, H, periodic=(periodic, periodic)), H)
    key = "halo_periodic" if periodic else "halo_clamped"
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[key].numpy(), ref[r], err_msg=f"rank {r}")


def test_neighbor_shift(ranks):
    fwd = _jax_blocks(lambda b: jhalo.neighbor_shift(b, 1, "x"))
    opened = _jax_blocks(lambda b: jhalo.neighbor_shift(b, 1, "y", periodic=False))
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["shift_x"].numpy(), fwd[r])
        np.testing.assert_array_equal(out["shift_y_open"].numpy(), opened[r])


def test_neighbor_shift_round_trip(ranks):
    x = _field()
    for r, out in enumerate(ranks):
        iy, ix = divmod(r, 2)
        np.testing.assert_array_equal(out["round_trip"].numpy(),
                                      x[:, iy * 4:(iy + 1) * 4, ix * 6:(ix + 1) * 6])


def test_host_to_global_and_gather(ranks):
    x = _field()
    for r, out in enumerate(ranks):
        iy, ix = divmod(r, 2)
        np.testing.assert_array_equal(out["host"], x[:, iy * 4:(iy + 1) * 4, ix * 6:(ix + 1) * 6])
        np.testing.assert_array_equal(out["whole"].numpy(), x)


def test_collective_counters(ranks):
    """Each exchange_2d posts 4 sends; the shifts 4 (the open one: the rank
    at the top edge sends nothing); one all-gather of the whole field."""
    n_bytes = 4 * int(np.prod(SHAPE))
    for r, out in enumerate(ranks):
        c = out["counts"]
        assert c["p2p"]["calls"] == 8 + 3 + (1 if r < 2 else 0), c
        assert c["all_gather"] == {"calls": 1, "bytes": n_bytes, "max_bytes": n_bytes}
        assert c["all_reduce"]["calls"] == 0


@pytest.mark.parametrize("bc", ["periodic", "clamp"])
def test_block_stencils(ranks, bc):
    """Block shifts and taps across rank edges equal the whole-domain
    stencil's (``torch.roll``, or the clamped edge) on the block."""
    x = torch.tensor(_field())
    for r, out in enumerate(ranks):
        iy, ix = divmod(r, 2)
        cut = lambda a: a[..., iy * 4:(iy + 1) * 4, ix * 6:(ix + 1) * 6]
        for ax in (-2, -1):
            for s in range(-3, 4):
                want = cut(torch.roll(x, -s, dims=ax)) if bc == "periodic" else \
                    cut(stencil.shift(x, s, ax, bc))
                assert torch.equal(out["stencil"][(bc, ax, s)], want), (r, ax, s)
            for w in (1, 2, 3):
                taps = stencil.make_taps(x, -w, w, ax, bc)
                want = torch.stack([cut(taps(s)) for s in range(-w, w + 1)])
                assert torch.equal(out["taps"][(bc, ax, w)], want), (r, ax, w)


def test_block_stencil_counts(ranks):
    """One halo exchange per shift that moves (6 a bc and axis) and per
    tap buffer (3): 2 x 2 x 9 calls, each one batch of sends to the
    neighbours (two for the two-sided taps), no gather."""
    for out in ranks:
        c = out["stencil_counts"]
        assert c["halo"]["calls"] == 2 * 2 * (6 + 3), c
        assert c["p2p"]["calls"] == 2 * 2 * (6 + 2 * 3), c
        assert c["all_gather"]["calls"] == 0


@pytest.mark.parametrize("bc", ["periodic", "clamp"])
@pytest.mark.parametrize("w", [1, 2, 3])
def test_block_stencils_extent_one(bc, w):
    """On a (1, 1) mesh every halo is a local copy: the block is the domain,
    and its shifts and taps equal the undecomposed ones (``torch.roll`` for
    periodic), with no collective."""
    x = torch.tensor(_field())
    mesh = Mesh(shape=(1, 1), rank=0, device=torch.device("cpu"))
    halo.reset_counts()
    for ax in (-2, -1):
        with stencil.decomposed(mesh, x.shape[1:]):
            got = [stencil.shift(x, s, ax, bc) for s in (-w, w)]
            taps = stencil.make_taps(x, -w, w, ax, bc)
            got_taps = [taps(s) for s in range(-w, w + 1)]
        want = [stencil.shift(x, s, ax, bc) for s in (-w, w)]
        plain = stencil.make_taps(x, -w, w, ax, bc)
        if bc == "periodic":
            assert torch.equal(want[1], torch.roll(x, -w, dims=ax))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(t, plain(s)) for t, s in zip(got_taps, range(-w, w + 1)))
    c = halo.read_counts()
    assert c["halo"]["calls"] == 2 * 3 and c["p2p"]["calls"] == 0


def test_block_stencil_errors():
    """A halo wider than the block raises before any exchange, and so does
    a horizontal access to a tensor that is not an Eulerian block; a block
    grid narrower than the widest stencil halo is refused."""
    from wrf_partmc_tpu_torch.entry import make_config
    from wrf_partmc_tpu_torch.grid import block_grid, make_grid

    mesh = Mesh(shape=(2, 2), rank=0, device=torch.device("cpu"))
    blk = torch.zeros(3, 2, 4)
    with stencil.decomposed(mesh, (2, 4)):
        with pytest.raises(ValueError, match="wider than|> the block"):
            stencil.shift(blk, 3, -2)
        with pytest.raises(ValueError, match="not an Eulerian block"):
            stencil.shift(torch.zeros(3, 4, 2, 5), 1, -2)
        assert torch.equal(stencil.shift(blk, 1, -3), torch.roll(blk, -1, dims=0))
        with pytest.raises(ValueError, match="unknown bc"):
            stencil.shift(blk, 1, -1, "open")
    with pytest.raises(ValueError, match="narrower than the 3-point"):
        block_grid(make_grid(make_config(4, 8, 4, 4, 8)), mesh)
    grid = block_grid(make_grid(make_config(12, 8, 4, 4, 8)), mesh)
    assert (grid.ny, grid.nx, grid.global_shape, grid.offsets) == (4, 6, (8, 12), (0, 0))
    with pytest.raises(ValueError, match="a block already"):
        block_grid(grid, mesh)


@pytest.mark.parametrize("kind", ["uniform", "normal", "randint"])
def test_block_draws(ranks, kind):
    k = jax.random.key(5)
    ref = np.asarray({"uniform": lambda: jax.random.uniform(k, DRAW),
                      "normal": lambda: jax.random.normal(k, DRAW),
                      "randint": lambda: jax.random.randint(k, DRAW, -7, 1000)}[kind]())
    whole = {"uniform": rng.uniform, "normal": rng.normal,
             "randint": lambda kk, s, d: rng.randint(kk, s, d, -7, 1000)}[kind](
        rng.key(5), DRAW, "cpu")
    np.testing.assert_array_equal(whole.numpy(), ref)
    for r, out in enumerate(ranks):
        iy, ix = divmod(r, 2)
        np.testing.assert_array_equal(out[kind].numpy(),
                                      ref[:, iy * 4:(iy + 1) * 4, ix * 6:(ix + 1) * 6])


def test_block_draw_past_2_32():
    """A block whose global flat indices pass 2^32 hashes the hi/lo counter
    split, as the global draw does (checked on the draw's last rows)."""
    ny, nx, trail = 4096, 4096, 300          # 4096 * 4096 * 300 > 2^32
    b = rng.Block(ny, nx, ny - 1, nx - 2, 1, 2)
    got = rng.random_bits(rng.key(1), (1, 1, 2, trail), "cpu", block=b)
    idx = torch.arange(((ny - 1) * nx + nx - 2) * trail, (ny * nx) * trail, dtype=torch.int64)
    assert int(idx[-1]) >= 2 ** 32
    y0, y1 = rng.threefry2x32(*rng.key(1), idx >> 32, idx & 0xFFFFFFFF)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), (y0 ^ y1).numpy())


def test_launcher_exit_codes_and_time_limit(tmp_path):
    """The launcher sets WPMC_* for every rank, returns the code of the rank
    that failed first (3: rank 1 exits only once rank 0 has printed and
    written its file, and rank 0 then sleeps until the launcher kills it),
    and kills every rank at its time limit (124)."""
    flag = tmp_path / "rank0"
    cmd = [sys.executable, "-m", "wrf_partmc_tpu_torch.parallel.launch", "-n", "3",
           "--timeout", "60", "--", sys.executable, "-c",
           "import os, sys, time; r = int(os.environ['WPMC_PROC_ID']); "
           "assert os.environ['WPMC_NUM_PROCS'] == '3' and os.environ['WPMC_COORDINATOR']; "
           f"flag = {str(flag)!r}\n"
           "if r == 0:\n"
           "    print('hello', r, flush=True); open(flag, 'w').close(); time.sleep(60)\n"
           "elif r == 1:\n"
           "    while not os.path.exists(flag): time.sleep(0.01)\n"
           "    sys.exit(3)"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 3, res.stdout + res.stderr
    assert "[rank 0] hello 0" in res.stdout
    slow = spawn(2, [sys.executable, "-c", "import time; time.sleep(60)"], timeout_s=2.0)
    assert [c for c, _ in slow] == [124, 124] and slow.cause is None and slow.code == 124


def test_launcher_reports_the_rank_that_failed_first():
    """Rank 1 fails with 3 while rank 0 still runs: rank 0 is killed and
    held as -9, and the run's code is rank 1's, not the killed rank's."""
    code = ("import os, sys, time\n"
            "if os.environ['WPMC_PROC_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)")
    res = spawn(2, [sys.executable, "-c", code], timeout_s=60.0)
    assert res.cause == 1 and [c for c, _ in res] == [-9, 3] and res.code == 3


def test_mesh_device_must_match_backend():
    """A cuda mesh never runs over gloo."""
    pdist.init(f"127.0.0.1:{free_port()}", 1, 0, "cpu", timeout_s=TIMEOUT_S)
    try:
        with pytest.raises(ValueError, match="cannot run on the gloo backend"):
            make_mesh(device="cuda")
    finally:
        pdist.shutdown()
