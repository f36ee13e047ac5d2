"""Readings that set the limits of ``correct``: the program's, and its
control's, over several seeds of one cell, in one process.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 \\
        [--control-seeds 11,12,13] [--seconds 3]

For each seed it runs the cell as ``portbench.run`` does, with a short
window, and prints one JSON line of the compared numbers; then, for each
control seed, the same with the control in the program's place: the
reference at the next narrower precision (``cells.LOWER``). The lower
reading of a number is the largest the program gives, the upper the
smallest the control gives. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def readings(workload: str, seeds, control_seeds, seconds: float) -> list:
    out = []
    for side, ss in (("program", seeds), ("control", control_seeds)):
        for s in ss:
            r = run.run_cell(run.ROOT, workload, s, seconds, False,
                             control=side == "control")
            line = {"side": side, "seed": s, "correct": r["correct"],
                    "attempted": r["attempted"],
                    "checks": {k: v["value"] for k, v in r["checks"].items()},
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()
                                if k != "setup_s"}}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    why = run.prepare(int(run.bspec.Bench(run.ROOT).workload(a.workload)["chips"]))
    if why:
        print(f"portbench: {why}", file=sys.stderr)
        return 2
    seeds = [int(x) for x in a.seeds.split(",") if x]
    cseeds = [int(x) for x in a.control_seeds.split(",") if x]
    lines = readings(a.workload, seeds, cseeds, a.seconds)
    names = lines[0]["checks"].keys()
    for name in names:
        lo = max((ln["checks"][name] for ln in lines
                  if ln["side"] == "program"), default=None)
        hi = min((ln["checks"][name] for ln in lines
                  if ln["side"] == "control"), default=None)
        print(f"{name}: program max {lo}, control min {hi}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
