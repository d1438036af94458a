"""kernel_load_s: ``ops._cuda.lib()``, loading (on a cell's first run in a
checkout, building) the hand-written kernels (s).  Layer: kernel loader."""


def read(run):
    return run.kernel_load_s if run.kernel_load_s > 0.0 else None
