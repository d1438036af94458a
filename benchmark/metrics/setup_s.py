"""setup_s: from the process's start to the first timed step: imports,
CUDA's start, loading the kernels, the build and the warm-up (s)."""


def read(run):
    return run.setup_s
