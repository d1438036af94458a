"""The reading of a profiler trace, and the spans, on made-up events."""

import json

import pytest

from benchmark import trace


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_read_trace(tmp_path):
    events = [
        _ev("user_annotation", trace.WINDOW_RANGE, 1000.0, 1000.0),
        _ev("cpu_op", "aten::add", 1000.0, 100.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1010.0, 5.0, corr=1),
        _ev("kernel", "void thomas_regs<8>(Launch)", 1100.0, 100.0, tid=7, corr=1),
        _ev("kernel", "elementwise_kernel", 1150.0, 100.0, tid=8, corr=2),   # overlaps
        _ev("gpu_memcpy", "Memcpy DtoD", 1400.0, 50.0, tid=7, corr=3),
        _ev("cpu_op", "aten::nonzero", 1460.0, 300.0),
        _ev("user_annotation", trace.COUNT_RANGE, 1500.0, 20.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1505.0, 5.0, corr=4),
        _ev("kernel", "reduce_kernel", 1520.0, 100.0, tid=7, corr=4),        # the counting
        _ev("kernel", "gather_rows_kernel", 1900.0, 200.0, tid=7, corr=5),  # past the window
        _ev("gpu_user_annotation", trace.WINDOW_RANGE, 1000.0, 1000.0, tid=7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace.read_trace(str(path))
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx((150 + 50 + 100) * 1e-6)
    assert got["launches"] == 3
    assert got["kernel_s"]["K1"] == pytest.approx(100e-6)
    assert got["kernel_s"]["K3"] == pytest.approx(100e-6)
    assert got["device_ops"][0][0] in ("void thomas_regs<8>(Launch)", "elementwise_kernel")
    gaps = got["idle_gaps"]
    assert gaps[0] == ["aten::nonzero", pytest.approx(450e-6)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert sum(g[1] for g in gaps) == pytest.approx(1e-3 - got["busy_s"])


def test_spans_restore():
    from benchmark.tests import test_bench_trace as me
    calls = []
    me.target = lambda x: x + 1
    with trace.Spans(["benchmark.tests.test_bench_trace:target"], lambda: calls.append(1)) as s:
        assert me.target(1) == 2
    assert s.calls["benchmark.tests.test_bench_trace:target"] == 1 and len(calls) == 2
    assert me.target.__name__ == "<lambda>"
