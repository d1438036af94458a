"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted`` (the steps timed), ``failed`` (the
compared numbers over their limits), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown`` of the profiled phase, and last
``compared``: each number the output comparison read, with its limit.
The compared numbers are also the last lines of standard error.

The run exits non-zero and prints no result when the card (or enough
cards) is missing, a file the cell names is missing or inconsistent, or a
module of JAX or of the JAX package is loaded once the window has
closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(obj: dict, lines: list) -> None:
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    from . import cell as cellrun
    from . import spec

    try:
        cell = spec.find_cell(args.workload)
    except spec.SpecError as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name!r} needs {cell.chips} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if cell.chips != 1:
        print(f"cell {cell.name!r}: this harness runs cells on one card", file=sys.stderr)
        return 2
    part = cellrun.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    obj, lines = cellrun.result(part, cell)
    bad = cellrun.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    emit(obj, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
