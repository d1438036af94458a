"""Peak device memory of the em_uniform coupled step across checkouts.

    git archive <commit> | tar -x -C build/hist/<name>
    python -m wrf_partmc_tpu_torch.tools.peak_history build/hist/<name> ... .

Each argument is the root of a checkout, an earlier commit of the port
unpacked with ``git archive`` or ``.`` for this one.  This checkout's
bench module (``wrf_partmc_tpu_torch/bench.py``) is copied into each
earlier checkout's package, and its coupled worker runs there in a fresh
process on the card, so every tree is measured the same way through its
own ``entry.build``: the chemistry-off em_uniform step at 40x40x10, 1000
particles per cell, capacity 1280, a warm-up window and three windows of
``--steps`` steps (step 0 coagulates).  One line per checkout gives the
peak ``torch.cuda.max_memory_allocated()`` of the build and of the steps
(reset after the build), the median ms/step and the kernels' launches.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

from .. import bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    worst = 0
    for root in args.roots:
        root = os.path.abspath(root)
        dst = os.path.join(root, "wrf_partmc_tpu_torch", "bench.py")
        if not os.path.exists(dst) or not os.path.samefile(dst, bench.__file__):
            shutil.copyfile(bench.__file__, dst)
        try:
            r = bench._spawn("coupled", bench._args(nx=40, ny=40, nz=10, steps=args.steps,
                                                    n_part=1000, cap=1280), args.device,
                             root=root)
        except bench.WorkerFailed as e:
            print(e, flush=True)
            r = None
        if r is None:
            worst = 1
            continue
        print("PEAK " + json.dumps({"root": root, "build_gib": r["peak_gib"]["build"],
                                    "steps_gib": r["peak_gib"]["steps"],
                                    "ms": 1e3 * r["t"] / args.steps,
                                    "launches": r["launches"]}), flush=True)
    return worst


if __name__ == "__main__":
    raise SystemExit(main())
