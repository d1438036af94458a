"""The readings a cell's limits are set from, on the chip at the cell's size.

    python -m benchmark.control --workload <cell> --seeds 11 12 ... [--control-seeds 11 12 13]

For each seed, in one process: the program's build, its warm-up and one
cadence (the window's last step ends a cadence, as in a run), then the
comparison of that step with the plain reference (the program's reading)
and, for the control seeds, the same comparison with the reference in
bfloat16 in the program's place (the control's reading).  One JSON line a
seed, then a summary: each number's largest program reading (the lower
reading) and smallest control reading (the upper reading).  Not run by
the benchmark's runs.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    from . import cell as cellrun
    from . import compare, spec
    from .window import cadence_of, run_window, warm_up

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    device = "cuda"
    sync = cellrun.syncer(device)
    builder = spec.builder(cell.config["name"])
    lower, upper = {}, {}
    for seed in args.seeds:
        model, state = builder.build(cell.config, cell.traffic, seed, device)
        fp = compare.fingerprint(state)
        cadence = cadence_of(model.cfg)
        box = [state]
        del state
        warm_up(model, box, cadence)
        win = run_window(model, box, cadence, 0.0, sync)
        prev, out = win.prev, win.state
        del model, win
        cellrun.free_device(device)
        control = seed in args.control_seeds
        got = cellrun.judge(cell, seed, device, prev, out, fp, control=control)
        got, ctrl = got if control else (got, None)
        del prev, out
        cellrun.free_device(device)
        line = {"seed": seed, "program": got}
        for k, v in got.items():
            lower[k] = max(lower.get(k, 0.0), v)
        if ctrl is not None:
            line["control"] = ctrl
            for k, v in ctrl.items():
                upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "seeds": args.seeds,
                      "control_seeds": args.control_seeds, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
