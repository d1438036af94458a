"""k6_hit_share: the window's transport steps whose move draw and class
ranks ran as one K6 launch: the change over the window of
``transport.K6_COUNTS``' K6 launches over its transport steps
(launches/step; 1.0 on the card, where every transport step launches K6
once).  None where the program keeps no such counter or the window ran no
transport step."""

COUNTERS = ("wrf_partmc_tpu_torch.models.coupled.transport:K6_COUNTS",)


def read(run):
    counts = run.counters.get(COUNTERS[0])
    if not counts or not counts.get("steps"):
        return None
    return counts.get("k6", 0) / counts["steps"]
