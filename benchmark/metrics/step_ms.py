"""step_ms: the window's wall time over all its steps (ms/step).  The
window is whole cadences from a synchronise to a synchronise."""


def read(run):
    return 1e3 * run.window_s / run.steps
