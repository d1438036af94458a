"""kernel_roofline: the sum of every K1-K5 call's bound (``roofline``, from
the inputs each call was handed) over the sum of their device time in the
profiled phase's trace (%)."""


def read(run):
    if run.trace is None:
        return None
    device_s = sum(run.trace["kernel_s"].values())
    bound_s = 1e-3 * sum(ms for _, ms in run.kernel_bounds)
    if device_s <= 0.0 or bound_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
