"""kernel_share: K1-K5's device time over all the device's busy time (the
union of its operations) in the profiled phase (%)."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0.0:
        return None
    return 100.0 * sum(run.trace["kernel_s"].values()) / run.trace["busy_s"]
