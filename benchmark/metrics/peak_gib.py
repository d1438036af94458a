"""peak_gib: ``torch.cuda.max_memory_allocated`` over the window, the
stats reset after the warm-up (GiB)."""


def read(run):
    return run.peak_bytes / 2.0 ** 30 if run.peak_bytes else None
