"""The least time the card could take for each hand-written kernel's call.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W limit): 3.35 TB/s of device memory, 67e12 float32 operations a
second outside the tensor cores (a multiply-add counts two), 33.5e12
int32 operations and 34e12 float64 operations.  A bound is the larger of
the bytes over the memory rate and the operations over the slowest unit's
rate: inputs read once, outputs written once, and where the work depends
on the data, what these inputs need.  These are the counts that
``chip_smoke.py`` used for its kernel tables, taken as numbers (rows
moved, slots alive, branches taken) so that the benchmark can count them
from each call's inputs.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
FP64_OPS_PER_S = 34e12
FMA_PER_S = FP32_OPS_PER_S / 2

# the kernels' CUDA function names, as the profiler's trace gives them
KERNEL_NAMES = {"K1": ("thomas_regs", "thomas_window"), "K2": ("scatter_rows_kernel",),
                "K3": ("gather_rows_kernel",), "K4": ("threefry_draw_kernel",),
                "K5": ("mie_fit_bulk_kernel",)}


def kernel_of(name: str) -> str | None:
    """Which of K1-K5 a trace's kernel name is, or None."""
    for k, names in KERNEL_NAMES.items():
        if any(n in name for n in names):
            return k
    return None


def bound(n_bytes: float, n_ops: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations") to move ``n_bytes`` and do ``n_ops``
    float32 operations."""
    t_b = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_o = 1e3 * n_ops / FP32_OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k1_bound(coef_elements: int, field_elements: int) -> tuple:
    """K1 (``thomas_solve``): the three diagonals as handed (broadcast ones
    read once) and every right-hand side read once, every solution written
    once; 9 operations an unknown (7 in the forward sweep, 2 back)."""
    return bound(4 * (coef_elements + 2 * field_elements), 9 * field_elements)


def scatter_bound(C: int, CH: int, L1: int, L2: int, moved: int) -> tuple:
    """K2 (``scatter_rows``) on a [C, CH, L1] payload into L2 slots: the
    ``moved`` rows with a destination in [0, L2) read once, the index read
    once, the whole output written once."""
    return bound(4 * (moved * CH + C * L1 + C * CH * L2))


def gather_bound(C: int, CH: int, L1: int, L2: int, rows: int) -> tuple:
    """K3 (``gather_rows``) of L2 slots from a [C, CH, L1] payload: each of
    the ``rows`` distinct source rows read once, the index read once, the
    whole output written once."""
    return bound(4 * (rows * CH + C * L2 + C * CH * L2))


def k4_bound(mode: str, n: int, blocked: bool, n_small: int = 0, n_ge5: int = 0) -> tuple:
    """K4 (``threefry_draw``) drawing ``n`` elements in ``mode`` ("bits",
    "uniform" or "normal"); a normal's branches are counted by its uniform
    u: ``n_small`` elements with u*u < sqrt(2) - 1 and ``n_ge5`` with
    -log1p(-u*u) >= 5.  Bytes written, or the slowest unit's operations."""
    i32 = n * (74 + (11 if blocked else 0) + (2 if mode != "bits" else 0))
    f32 = 4 * n if mode != "bits" else 0
    f64 = 0
    if mode == "normal":
        i32 += 4 * (n - n_small)
        f32 += 6 * n + 7 * n_small + 12 * (n - n_small)
        f64 += 16 * n + 28 * n_small + 20 * (n - n_small) + n_ge5
    t_b = 1e3 * n * (8 if mode == "bits" else 4) / HBM_BYTES_PER_S
    t_o = 1e3 * max(i32 / INT32_OPS_PER_S, f32 / FP32_OPS_PER_S, f64 / FP64_OPS_PER_S)
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k5_bound(C: int, P: int, W: int, live: int) -> tuple:
    """K5 (``mie_fit_bulk``) on [C, P] slots, ``live`` of them carrying a
    number, at W bands: 16 bytes a slot read and 12 a cell and band
    written, or 60 x 45 + W x (3 x 60 + 58) float32 multiply-adds a live
    slot."""
    t_b = 1e3 * (16.0 * C * P + 12.0 * W * C) / HBM_BYTES_PER_S
    t_o = 1e3 * live * (60 * 45 + W * (3 * 60 + 58)) / FMA_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
