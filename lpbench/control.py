"""Readings for the limits of ``correct``: the numbers the comparison gives,
for a cell, over many seeds in one process, for the program as the
configuration states it and for the control.

    python3 lpbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--mode program|control|both]

Each seed runs the cell's set-up (the warm-up, which captures the
program's graphs, only for a mode's first seed), a window of
``--seconds`` (at least one call), then the comparison.

The control is the program with its own lower-precision path switched on:
the configuration's ``control_options``, which drop the float64 finish so
that every lane is solved in float32 alone.  A short window serves: the
comparison reads the same sample of LPs whatever the window's length.  One
JSON line a seed and mode goes to standard output.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", choices=("program", "control", "both"), default="both")
    args = ap.parse_args(argv)

    import torch

    from lpbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device: no readings", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    modes = ("program", "control") if args.mode == "both" else (args.mode,)
    warmed = set()
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in modes:
            opts = cell.config["control_options"] if mode == "control" else None
            runner = harness.Runner(cell, seed, "cuda", options=opts)
            t0 = time.perf_counter()
            try:
                # one warm-up a mode: the graphs it captures serve every seed
                runner.setup(t0, warm=mode not in warmed)
                warmed.add(mode)
                runner.window(args.seconds)
                verdict = runner.compare()
            finally:
                runner.close()
            run = runner.run
            print(json.dumps({"workload": cell.name, "seed": seed, "mode": mode,
                              "correct": verdict["correct"], "failed": verdict["failed"],
                              "attempted": verdict["attempted"], "values": verdict["values"],
                              "setup_s": run.setup_s, "window_s": run.window_s,
                              "lp_per_s": run.lps / run.window_s,
                              "captures_in_window": run.captures_in_window}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
