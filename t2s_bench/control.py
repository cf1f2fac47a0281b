"""The readings that the limits of a cell's output check are set from, in
one process on the card:

    python3 -m t2s_bench.control --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3] [--seconds 0]

For each seed: the cell's set-up and a short window at its own load (one
batch at ``--seconds 0``), then the check's numbers of the program (the
lower readings) and, on the first ``--control-seeds`` seeds, of the
control: the plain reference at the configuration's control precision
(the "control" group of its file), put in the program's place on the same
served inputs, with ``control_correct``: whether its numbers keep within
the cell's limits, which a sound limit makes false.  One JSON line per
seed; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from t2s_bench import layout, run as R


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    cell = layout.cell(args.workload)
    for i, seed in enumerate(args.seeds):
        res = R.run(cell, seed, args.seconds, False,
                    control=i < args.control_seeds)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {k: c["value"] for k, c in
                                      res["checks"].items()},
                          "control": res.get("control"),
                          "control_correct": res.get("control_correct")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
