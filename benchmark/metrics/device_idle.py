"""device_idle: the share of the profiled window in which no operation
ran on the device: one minus the union of its operations over the
window (%)."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
