"""graph_hit_share: the window's dycore steps that replayed a captured
CUDA graph over all its dycore steps: the change over the window of
``solve.GRAPH_COUNTS``' replays over its captures, replays and eager calls
(replays/call).  A capture inside the window counts as a miss.  None where
the program keeps no such counter."""

COUNTERS = ("wrf_partmc_tpu_torch.models.dycore.solve:GRAPH_COUNTS",)


def read(run):
    counts = run.counters.get(COUNTERS[0])
    if counts is None:
        return None
    calls = sum(counts.get(k, 0) for k in ("captures", "replays", "eager"))
    return counts.get("replays", 0) / calls if calls else None
