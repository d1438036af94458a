"""``k6_hit_share``: the program counter ``transport.K6_COUNTS`` read over
the window, as ``graph_hit_share`` reads the dycore's."""

import time

import pytest

from benchmark import cell as C
from benchmark import spec, trace
from benchmark.tests.tiny import tiny_cell

SITE = "wrf_partmc_tpu_torch.models.coupled.transport:K6_COUNTS"


def _read(counters):
    run = C.Run(cell=spec.find_cell("em_uniform.p1000"), traced=True, counters=counters)
    return spec.reader("k6_hit_share").read(run)


def test_reads_a_planted_change(monkeypatch):
    from wrf_partmc_tpu_torch.models.coupled import transport

    before = trace.read_counters([SITE])
    planted = {k: v + 7 for k, v in transport.K6_COUNTS.items()}
    monkeypatch.setattr(transport, "K6_COUNTS", planted)
    change = trace.counter_change(before, trace.read_counters([SITE]))
    assert change == {SITE: {"steps": 7, "k6": 7}}
    assert _read(change) == 1.0


def test_none_where_the_program_lacks_the_counter(monkeypatch):
    from wrf_partmc_tpu_torch.models.coupled import transport

    monkeypatch.delattr(transport, "K6_COUNTS")
    assert trace.read_counters([SITE]) == {}
    assert _read({}) is None


@pytest.mark.parametrize("counts,share", [({"steps": 4, "k6": 4}, 1.0),
                                          ({"steps": 4, "k6": 0}, 0.0),
                                          ({"steps": 0, "k6": 0}, None)])
def test_k6_hit_share(counts, share):
    assert _read({SITE: counts}) == share


def test_a_cpu_window_counts_steps_and_no_launch():
    part = C.run_cell(tiny_cell("em_uniform.p1000"), 3100000013, 0.0, True, "cpu",
                      time.time())
    run = part["run"]
    # on the CPU every transport step takes the plain chain: one step a window step
    assert run.counters[SITE] == {"steps": run.steps, "k6": 0}
    assert part["values"]["k6_hit_share"] == 0.0
