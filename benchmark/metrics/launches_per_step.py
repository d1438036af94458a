"""launches_per_step: the kernels the device ran in the profiled phase's
trace over its steps (launches/step)."""


def read(run):
    if run.trace is None or not run.trace_steps or not run.trace["launches"]:
        return None
    return run.trace["launches"] / run.trace_steps
