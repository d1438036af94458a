"""build_s: the builder (``builders/<config>.py``) on the card, from a
synchronise to a synchronise (s).  Layer: entry/build."""


def read(run):
    return run.build_s
