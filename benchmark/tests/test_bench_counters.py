"""The program's counters over the window: the harness copies each counter
a reader names (``COUNTERS``) after the warm-up and again after the
window, and keeps the change, so the warm-up's counts are left out and
nothing of the program is reset; a counter the program lacks is left out
and its reader reads None."""

import time

import pytest

from benchmark import cell as C
from benchmark import spec, trace
from benchmark.tests.tiny import tiny_cell

SITE = "wrf_partmc_tpu_torch.models.dycore.solve:GRAPH_COUNTS"


def test_the_change_leaves_out_the_warm_up():
    from wrf_partmc_tpu_torch.models.dycore import solve

    total = sum(solve.GRAPH_COUNTS.values())
    part = C.run_cell(tiny_cell("em_uniform.p1000"), 3100000007, 0.0, True, "cpu",
                      time.time())
    run = part["run"]
    # on the CPU every dycore step runs eagerly: one call a step of the window
    assert run.counters[SITE] == {"captures": 0, "replays": 0, "eager": run.steps}
    # the program counted the warm-up's steps too (two, at a cadence of one)
    assert sum(solve.GRAPH_COUNTS.values()) - total == run.steps + 2
    assert part["values"]["graph_hit_share"] == 0.0


def test_an_untraced_run_copies_no_counter():
    part = C.run_cell(tiny_cell("em_uniform.p1000"), 3100000009, 0.0, False, "cpu",
                      time.time())
    assert part["run"].counters == {}


def test_change_of_made_up_counts():
    before = {"a:X": {"n": 3, "m": 1.5}, "a:Y": {"k": 1}}
    after = {"a:X": {"n": 10, "m": 2.0, "new": 4}, "a:Y": {"k": 1}}
    assert trace.counter_change(before, after) == {"a:X": {"n": 7, "m": 0.5, "new": 4},
                                                   "a:Y": {"k": 0}}


def test_a_counter_the_program_lacks(monkeypatch, tmp_path):
    from wrf_partmc_tpu_torch.models.dycore import solve

    got = trace.read_counters([SITE, "wrf_partmc_tpu_torch.models.dycore.solve:NO_COUNTS",
                               "wrf_partmc_tpu_torch.no_such_module:COUNTS"])
    assert got == {SITE: dict(solve.GRAPH_COUNTS)} and got[SITE] is not solve.GRAPH_COUNTS
    monkeypatch.delattr(solve, "GRAPH_COUNTS")
    assert trace.read_counters([SITE]) == {}
    run = C.Run(cell=spec.find_cell("em_uniform.p1000"), traced=True)
    assert spec.reader("graph_hit_share").read(run) is None
    # a module that is there but fails to import is an error, not a missing counter
    (tmp_path / "wpmc_broken_counts.py").write_text("import wpmc_no_such_package\nX = {}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ModuleNotFoundError, match="wpmc_no_such_package"):
        trace.read_counters(["wpmc_broken_counts:X"])


@pytest.mark.parametrize("counts,share", [({"captures": 0, "replays": 9, "eager": 1}, 0.9),
                                          ({"captures": 1, "replays": 3, "eager": 0}, 0.75),
                                          ({"captures": 0, "replays": 0, "eager": 0}, None)])
def test_graph_hit_share(counts, share):
    run = C.Run(cell=spec.find_cell("em_uniform.p1000"), traced=True, counters={SITE: counts})
    assert spec.reader("graph_hit_share").read(run) == share
