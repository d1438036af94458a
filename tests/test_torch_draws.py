"""The port's draws on the CPU and K4's arguments (``utils/rng.py``,
``ops/threefry.py``, ``csrc/threefry.cu``).

- On a CPU device, ``random_bits``/``uniform``/``normal``/``randint`` take
  the plain version and give ``jax.random``'s draws bit for bit, flat at
  the shapes of ``tests/test_torch_random.py`` under the keys of seeds 0,
  1, 12345 and 2^31 - 1, and as every block of a (2, 2) mesh against the
  slice of the global ``jax.random`` draw; K4's launch counter stays 0.
- K4's block arguments (``Block.kernel_args``), evaluated in numpy with
  the kernel's own index formula, give ``Block.flat_index`` for every block
  of the (2, 2) meshes of 40x40 (em_uniform) and 72x72 (CARES) at trail 1
  and 1280, and past 2^32.
- The kernel's float32 constants (hex literals in ``csrc/threefry.cu``)
  are the plain version's, rounded to float32.
- A draw asked of a CUDA device on a host without a card raises; it does
  not fall back to the plain version.
"""

import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wrf_partmc_tpu_torch.ops import threefry
from wrf_partmc_tpu_torch.parallel.mesh import Mesh
from wrf_partmc_tpu_torch.utils import rng

SOURCE = Path(__file__).resolve().parents[1] / "wrf_partmc_tpu_torch" / "csrc" / "threefry.cu"

SEEDS = [0, 1, 12345, 2 ** 31 - 1]
SHAPES = [(), (1,), (7,), (3, 5, 7), (4, 4, 2, 48)]       # tests/test_torch_random.py


def kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def jax_draw(kind, k, shape):
    if kind == "bits":
        return np.asarray(jax.random.bits(k, shape)).astype(np.int64)
    if kind == "uniform":
        return np.asarray(jax.random.uniform(k, shape))
    if kind == "normal":
        return np.asarray(jax.random.normal(k, shape))
    return np.asarray(jax.random.randint(k, shape, -7, 1000)).astype(np.int64)


def port_draw(kind, k, shape, block=None):
    if kind == "bits":
        return rng.random_bits(k, shape, "cpu", block)
    if kind == "uniform":
        return rng.uniform(k, shape, "cpu", block=block)
    if kind == "normal":
        return rng.normal(k, shape, "cpu", block)
    return rng.randint(k, shape, "cpu", -7, 1000, block)


def _bitwise(a: np.ndarray, b: torch.Tensor) -> None:
    b = b.numpy()
    assert a.shape == b.shape
    if b.dtype == np.float32:
        assert a.dtype == np.float32
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(b, a)


@pytest.fixture
def no_launch():
    threefry.threefry_draw.launches = 0
    yield
    assert threefry.threefry_draw.launches == 0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["bits", "uniform", "normal", "randint"])
def test_cpu_draw_bitwise(no_launch, kind, seed, shape):
    k = jax.random.fold_in(jax.random.key(seed), 11)
    _bitwise(jax_draw(kind, k, shape), port_draw(kind, kd(k), shape))


# global draws (n0, ny, nx, trail...) cut into the blocks of a (2, 2) mesh
BLOCK_DRAWS = [(3, 8, 12), (2, 8, 12, 5), (2, 4, 6, 3, 2)]


@pytest.mark.parametrize("shape", BLOCK_DRAWS, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["bits", "uniform", "normal", "randint"])
def test_cpu_block_draw_bitwise(no_launch, kind, seed, shape):
    k = jax.random.key(seed)
    ref = jax_draw(kind, k, shape)
    ny, nx = shape[1:3]
    for r in range(4):
        mesh = Mesh((2, 2), r, torch.device("cpu"))
        b = mesh.draw_block(ny, nx)
        rows, cols = mesh.slices(ny, nx)
        got = port_draw(kind, kd(k), (shape[0], b.ny_l, b.nx_l, *shape[3:]), b)
        _bitwise(np.ascontiguousarray(ref[:, rows, cols]), got)


def kernel_index(n: int, args) -> np.ndarray:
    """The global index ``csrc/threefry.cu::global_index`` gives each element
    e < n of a block draw: 32-bit element arithmetic, a 64-bit cell."""
    ny, nx, iy0, ix0, ny_l, nx_l, trail = args
    e = np.arange(n, dtype=np.uint32)
    t = e % np.uint32(trail)
    c = e // np.uint32(trail)
    jx = c % np.uint32(nx_l)
    c = c // np.uint32(nx_l)
    jy = c % np.uint32(ny_l)
    i0 = c // np.uint32(ny_l)
    cell = (i0.astype(np.uint64) * np.uint64(ny) + np.uint64(iy0) + jy) * np.uint64(nx) \
        + np.uint64(ix0) + jx
    return cell * np.uint64(trail) + t


@pytest.mark.parametrize("grid,n0", [(40, 10), (72, 24)])
@pytest.mark.parametrize("trail", [(), (1280,)], ids=["trail 1", "trail 1280"])
def test_kernel_block_index_is_flat_index(grid, n0, trail):
    """Every (2, 2) block of the em_uniform (40x40, 10 levels) and CARES
    (72x72, 24 levels) draws; with a trail of 1280 particle slots two
    levels, so the arrays stay small."""
    n0 = 2 if trail else n0
    for r in range(4):
        b = Mesh((2, 2), r, torch.device("cpu")).draw_block(grid, grid)
        shape = (n0, b.ny_l, b.nx_l, *trail)
        args = b.kernel_args(shape)
        assert args == (grid, grid, b.iy0, b.ix0, grid // 2, grid // 2, math.prod(trail))
        want = b.flat_index(shape, "cpu").reshape(-1).numpy()
        np.testing.assert_array_equal(kernel_index(math.prod(shape), args).astype(np.int64),
                                      want)


def test_kernel_block_index_past_2_32():
    """A block whose global indices pass 2^32 (the high counter word is
    carried)."""
    b = rng.Block(4096, 4096, 4095, 4094, 1, 2)
    shape = (1, 1, 2, 300)
    want = b.flat_index(shape, "cpu").reshape(-1).numpy()
    assert int(want[-1]) >= 2 ** 32
    got = kernel_index(600, b.kernel_args(shape)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_kernel_args_refuse_a_foreign_shape():
    b = rng.Block(8, 12, 4, 6, 4, 6)
    with pytest.raises(ValueError, match="axes 1, 2 must be"):
        b.kernel_args((2, 6, 4, 3))


def _c_floats(text: str) -> list:
    return [float.fromhex(v.strip().rstrip("f")) for v in text.split(",")]


@pytest.mark.parametrize("name,values", [
    ("kLogP", rng._LOG_P), ("kLog1pNum", rng._LOG1P_NUM), ("kLog1pDen", rng._LOG1P_DEN),
    ("kErfinvLt5", rng._ERFINV_LT5), ("kErfinvGe5", rng._ERFINV_GE5)])
def test_kernel_constant_tables(name, values):
    src = SOURCE.read_text()
    body = re.search(rf"float {name}\[\d+\] = \{{([^}}]*)\}};", src).group(1)
    assert _c_floats(body) == [rng._f32(v) for v in values]


def test_kernel_scalar_constants():
    src = SOURCE.read_text()
    got = {m.group(1): float.fromhex(m.group(2).rstrip("f")) for m in re.finditer(
        r"constexpr float (k\w+) = (-?0x[0-9a-fp.+-]+f);", src)}
    assert got == {"kMinNormal": rng._f32(1.17549435e-38),
                   "kSqrtHalf": rng._f32(0.707106781186547524),
                   "kLogC1": rng._f32(-2.12194440e-4), "kLogC2": rng._f32(0.693359375),
                   "kLog1pCut": rng._f32(0.41421356237309504880), "kSqrt2": rng._SQRT2}
    assert (rng.NORMAL_LO, rng.NORMAL_SPAN) == (rng._f32(np.nextafter(np.float32(-1), 0)), 2.0)


@pytest.mark.parametrize("kind", ["bits", "uniform", "normal", "randint"])
def test_cuda_draw_without_a_card_raises(kind):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the draw runs on it")
    threefry.threefry_draw.launches = 0
    draw = {"bits": lambda: rng.random_bits(rng.key(0), (16,), "cuda"),
            "uniform": lambda: rng.uniform(rng.key(0), (16,), "cuda"),
            "normal": lambda: rng.normal(rng.key(0), (4, 2, 2, 3), "cuda",
                                         rng.Block(4, 4, 2, 2, 2, 2)),
            "randint": lambda: rng.randint(rng.key(0), (16,), torch.device("cuda"), 0, 9)}
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        draw[kind]()
    assert threefry.threefry_draw.launches == 0


def test_kernel_wrapper_refuses_bad_draws():
    with pytest.raises(ValueError, match="fewer than 2\\^32"):
        threefry.threefry_draw("uniform", (0, 1), (2 ** 16, 2 ** 16), "cuda")
    with pytest.raises(ValueError, match="mode 'gamma'"):
        threefry.threefry_draw("gamma", (0, 1), (4,), "cuda")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        threefry.threefry_draw("bits", (0, 1), (4,), "cpu")
