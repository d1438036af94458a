"""The benchmark's copies of the kernels' bound counts, held to the bound
column of the kernel tables in PERF.md (H100 SXM peaks)."""

import pytest

from benchmark import roofline


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.FP32_OPS_PER_S == 67e12 and roofline.INT32_OPS_PER_S == 33.5e12


def test_k1_cares_gases():
    # [24, 77, 72, 72] right-hand sides on [24, 72, 72] coefficients: 0.023323 ms
    ms, by = roofline.k1_bound(3 * 24 * 72 * 72, 24 * 77 * 72 * 72)
    assert by == "bytes" and ms == pytest.approx(0.023323, rel=1e-4)


def test_k2_cares_t1():
    # [124416, 33, 128] -> 448 slots, 5.56% of the rows moved: 2.2502 ms
    C, L1 = 124416, 128
    ms, by = roofline.scatter_bound(C, 33, L1, 448, round(0.0556 * C * L1))
    assert by == "bytes" and ms == pytest.approx(2.2502, rel=2e-4)


def test_k3_cares_coag():
    # a permutation of [124416, 33, 128]: every row read, 1.2740 ms
    C, L1 = 124416, 128
    ms, _ = roofline.gather_bound(C, 33, L1, 128, C * L1)
    assert ms == pytest.approx(1.2740, rel=1e-4)


def test_k4_uniform():
    ms, by = roofline.k4_bound("uniform", 10 * 40 * 40 * 1280, blocked=False)
    assert by == "operations" and ms == pytest.approx(0.046462, rel=1e-5)


def test_k5_cares():
    # [124416, 128] x 4 bands, 80% of the slots alive: 1.388697 ms
    C, P = 124416, 128
    ms, by = roofline.k5_bound(C, P, 4, round(0.8 * C * P))
    assert by == "operations" and ms == pytest.approx(1.388697, rel=1e-3)


def test_kernel_names():
    assert roofline.kernel_of("void thomas_regs<8>(Launch)") == "K1"
    assert roofline.kernel_of("gather_rows_kernel(float const*, int const*)") == "K3"
    assert roofline.kernel_of("void at::native::vectorized_elementwise_kernel") is None
