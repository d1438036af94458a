"""Batched tridiagonal (Thomas) column solver.

Port of ``wrf_partmc_tpu/ops/tridiag.py`` and its Pallas kernel
``ops/pallas_tridiag.py::_thomas_kernel``.  Two entries, each dispatching
on where the right-hand sides live:

* ``solve(dl, d, du, b)``: one right-hand side [n, ...] against diagonals
  that broadcast by column;
* ``solve_fields(dl, d, du, fields)``: several right-hand sides, each
  [n, *cols] or [L, n, *cols] in its own layout, that share one set of
  [n, *cols] coefficients (vertical diffusion's six fields).

A CPU tensor takes the plain PyTorch recurrence (:func:`solve_scan`, field
by field in :func:`solve_fields_scan`); a CUDA tensor launches the
hand-written kernel (``csrc/tridiag.cu``) through :func:`thomas_solve`,
one launch for every field, or raises.  There is no fallback between the
two.  Every layout decision of a launch is made by :func:`launch_plan`, a
pure function of shapes and strides that the CPU tests reach; the CUDA
wrapper only checks devices and types, calls it and launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _cuda

MAX_FIELDS = 8               # descriptors the kernel's parameter table holds
BUCKETS = (8, 16, 24, 32)    # level buckets whose sweeps run in registers
WINDOW_BYTES = 48 * 1024     # shared memory of one block of the window kernel
WINDOW_THREADS = 64
SMALL_GRID = 132 * 128       # below this many columns, 64-thread blocks
MAX_COLUMNS = 2**31 - 1      # the kernel's 32-bit column arithmetic


def solve(dl, d, du, b):
    """Solve A x = b for each trailing-batch column.

    dl, d, du, b: [n, ...] sub-, main-, super-diagonal and RHS; dl[0] and
    du[n-1] are ignored.  Diagonals may carry broadcastable batch dims.
    Returns x with the broadcast shape."""
    if b.is_cuda:
        return thomas_solve(dl, d, du, [b], cols=tuple(b.shape[1:]))[0]
    return solve_scan(dl, d, du, b)


def solve_fields(dl, d, du, fields):
    """Solve A x = f for every f in ``fields`` with one set of [n, *cols]
    coefficients; each f is [n, *cols] or [L, n, *cols] (L columns per
    coefficient column).  Returns the solutions in the fields' shapes."""
    if fields[0].is_cuda:
        return thomas_solve(dl, d, du, fields)
    return solve_fields_scan(dl, d, du, fields)


def solve_scan(dl, d, du, b):
    """Plain PyTorch Thomas recurrence (the kernel's reference version): the
    forward sweep then the back substitution, a Python loop over levels."""
    shape = torch.broadcast_shapes(dl.shape, d.shape, du.shape, b.shape)
    dl, d, du, b = (a.expand(shape) for a in (dl, d, du, b))
    n = shape[0]
    cp_prev = torch.zeros_like(b[0])
    dp_prev = torch.zeros_like(b[0])
    cps, dps = [], []
    for k in range(n):
        a = dl[k]
        denom = d[k] - a * cp_prev
        cp_prev = du[k] / denom
        dp_prev = (b[k] - a * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(b[0])
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        x_next = dps[k] - cps[k] * x_next
        xs[k] = x_next
    return torch.stack(xs)


def solve_fields_scan(dl, d, du, fields):
    """Plain version of :func:`solve_fields`: :func:`solve_scan` field by
    field, an [L, n, *cols] field as [n, L, *cols] against coefficients
    broadcast over L (the same float32 operations per element)."""
    out = []
    for f in fields:
        if f.dim() == d.dim():
            out.append(solve_scan(dl, d, du, f))
        else:
            x = solve_scan(dl[:, None], d[:, None], du[:, None], f.transpose(0, 1))
            out.append(x.transpose(0, 1))
    return out


def _column_count(shape, full) -> int:
    """Columns a broadcast diagonal of ``shape`` really holds against the
    field shape ``full`` = [n, *cols], when it varies only over a trailing
    block of the column dims (leading dims of size 1); else 0."""
    if len(shape) != len(full) or shape[0] != full[0]:
        return 0
    batch = tuple(shape[1:])
    lead = 0
    while lead < len(batch) and batch[lead] == 1:
        lead += 1
    if batch[lead:] != tuple(full[1 + lead:]):
        return 0
    return math.prod(batch[lead:])


def _cols_dense(shape, stride) -> bool:
    """Whether the column dims are one contiguous block (size-1 dims free)."""
    expect = 1
    for size, st in zip(reversed(shape), reversed(stride)):
        if size != 1 and st != expect:
            return False
        expect *= size
    return True


@dataclasses.dataclass(frozen=True)
class FieldPlan:
    """One descriptor of the kernel's table: a field of ``L`` stacked
    right-hand sides, read at (level, field) strides of b and written
    contiguous, over ``columns`` = L * cols threads from block ``block0``
    on."""
    L: int
    b_level: int
    b_field: int
    columns: int
    block0: int


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    n: int
    cols: int                 # columns of one field: the trailing block
    coef_cols: tuple          # columns dl, d, du hold (read at j % c)
    fields: tuple             # FieldPlan per right-hand side
    bucket: int               # 8/16/24/32: sweeps in registers; 0: shared-memory window
    window: int               # levels the window holds (bucket 0), else 0
    threads: int
    blocks: int

    def table(self, bs, xs):
        """The int64 table ``wpt_thomas_fields_f32`` reads, with the data
        pointers of the right-hand sides ``bs`` and solutions ``xs``."""
        head = [self.n, self.cols, *self.coef_cols, len(self.fields), self.bucket,
                self.threads, self.window, self.blocks]
        for f, b, x in zip(self.fields, bs, xs):
            head += [b.data_ptr(), x.data_ptr(), f.b_level, f.b_field, f.columns,
                     f.block0]
        return (ctypes.c_longlong * len(head))(*head)


@functools.lru_cache(maxsize=256)
def launch_plan(coef_shapes, field_shapes, field_strides, cols=None) -> LaunchPlan:
    """Every layout decision of one K1 launch, from shapes and strides.

    coef_shapes: the shapes of dl, d, du, each [n, ...] broadcasting by
    column over [n, *cols] (contiguous; read at column j % its count).
    field_shapes / field_strides: each right-hand side, [n, *cols] or
    [L, n, *cols], whose column dims must be one contiguous block; its
    level and field strides are free.  cols: the trailing column shape
    (default: that of d, [n, *cols]).

    Raises ValueError on a layout the kernel does not take."""
    n = coef_shapes[1][0]
    cols = tuple(coef_shapes[1][1:] if cols is None else cols)
    full = (n, *cols)
    m = math.prod(cols)
    coef_cols = []
    for name, shape in zip(("dl", "d", "du"), coef_shapes):
        c = _column_count(tuple(shape), full)
        if c == 0:
            raise ValueError(f"tridiag: {name} shape {tuple(shape)} does not broadcast "
                             f"by column over {full}")
        coef_cols.append(c)
    if not 1 <= len(field_shapes) <= MAX_FIELDS:
        raise ValueError(f"tridiag: {len(field_shapes)} fields; one launch takes 1 to "
                         f"{MAX_FIELDS}")
    if n <= BUCKETS[-1]:
        bucket = next(nb for nb in BUCKETS if n <= nb)
        window = 0
    else:
        bucket = 0
        window = min(n, WINDOW_BYTES // (8 * WINDOW_THREADS))
    total = 0
    layouts = []
    for shape, stride in zip(field_shapes, field_strides):
        shape, stride = tuple(shape), tuple(stride)
        if shape == full:
            L, b_field, b_level = 1, 0, stride[0]
        elif len(shape) == len(full) + 1 and shape[1:] == full:
            L, b_field, b_level = shape[0], stride[0], stride[1]
        else:
            raise ValueError(f"tridiag: field {shape} is neither {full} nor [L, *{full}]")
        first = len(shape) - len(cols)
        if not _cols_dense(shape[first:], stride[first:]):
            raise ValueError(f"tridiag: field {shape} with strides {stride}: its column "
                             f"dims {cols} are not one contiguous block")
        if L * m > MAX_COLUMNS:
            raise ValueError(f"tridiag: field {shape} has more than 2^31 - 1 columns")
        layouts.append((L, b_level, b_field))
        total += L * m
    if bucket == 0:
        threads = WINDOW_THREADS
    else:
        threads = 64 if total < SMALL_GRID else 128
    fields, block0 = [], 0
    for L, b_level, b_field in layouts:
        fields.append(FieldPlan(L=L, b_level=b_level, b_field=b_field, columns=L * m,
                                block0=block0))
        block0 += -(-L * m // threads)
    if block0 > MAX_COLUMNS:
        raise ValueError(f"tridiag: {block0} blocks exceed the launch grid")
    return LaunchPlan(n=n, cols=m, coef_cols=tuple(coef_cols), fields=tuple(fields),
                      bucket=bucket, window=window, threads=threads, blocks=block0)


def thomas_solve(dl, d, du, fields, cols=None):
    """Launch the CUDA Thomas kernel once on up to ``MAX_FIELDS``
    right-hand sides that share one set of coefficients.

    All inputs float32 on one CUDA device.  Each field is [n, *cols] or
    [L, n, *cols] in its own layout (column dims contiguous, level and
    field strides free).  dl, d, du are contiguous, each [n, *cols] or a
    broadcast over leading column dims (e.g. [n, 1, ny, nx] against a field
    [n, L, ny, nx], with ``cols`` = (L, ny, nx)), read by column modulus
    without a copy; ``cols`` defaults to d's.  The plan refuses any other
    layout.  Returns the contiguous solutions, one per field."""
    fields = tuple(fields)
    cols = tuple(d.shape[1:] if cols is None else cols)
    dev = fields[0].device
    named = [("dl", dl), ("d", d), ("du", du)] + [(f"field {i}", f) for i, f in enumerate(fields)]
    for name, a in named:
        if not a.is_cuda or a.device != dev:
            raise ValueError(f"thomas_solve: {name} must be on {dev}")
        if a.dtype != torch.float32:
            raise ValueError(f"thomas_solve: {name} must be float32")
    for name, a in named[:3]:
        if not a.is_contiguous():
            raise ValueError(f"thomas_solve: {name} must be contiguous")
    coef_shapes = (tuple(dl.shape), tuple(d.shape), tuple(du.shape))
    field_shapes = tuple(tuple(f.shape) for f in fields)
    plan = launch_plan(coef_shapes, field_shapes, tuple(f.stride() for f in fields), cols)
    xs = [torch.empty(f.shape, dtype=torch.float32, device=dev) for f in fields]
    if plan.blocks:
        err = _cuda.lib().wpt_thomas_fields_f32(
            dl.data_ptr(), d.data_ptr(), du.data_ptr(), plan.table(fields, xs),
            _cuda.stream_ptr(dev))
        _cuda.check(err, "thomas_solve")
        thomas_solve.launches += 1
    thomas_solve.shapes.add((*coef_shapes, field_shapes, cols))
    return xs


# launches: kernel launches; shapes: the arguments' shapes they were given,
# (dl, d, du, fields, cols), so a check can repeat them.  Both are read and
# reset by their caller.
thomas_solve.launches = 0
thomas_solve.shapes = set()
