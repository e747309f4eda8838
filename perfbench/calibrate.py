"""The readings that the check's limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --mode program|control|fault:<name> [--seconds S]

For each seed, one line of the check's numbers:
  * program: the served program as a run times it (train cells: set-up
    and the checked steps, no window; serve cells: an open loop of
    `--seconds` at the cell's rate);
  * control: the plain reference in float8 in the program's place, on the
    same weights, rows and photos;
  * fault:<name>: the program with a fault planted in its timed path (the
    kind's FAULTS: train `unchanged`, `half_batch`; serve `altered_answer`).
The benchmark's own runs never run these. The lines go to standard
output only: redirect it to keep them.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    sys.path[0] = ROOT
    from perfbench.run import _environment

    _environment(args.workload)  # the cell's host threads and caches, as its runs have them
    from perfbench import harness

    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.mode == "control":
            values = (cell.kind.control(cell, seed, "cuda")
                      if cell.traffic["kind"] == "train_closed"
                      else cell.kind.control(cell, seed, "cuda", args.seconds))
        else:
            fault = args.mode.split(":", 1)[1] if args.mode.startswith("fault:") else None
            outcome = cell.kind.run(cell, seed, args.seconds, False, "cuda", t,
                                    fault=fault,
                                    window=cell.traffic["kind"] != "train_closed")
            values = {c.name: c.value for c in outcome.checks}
            if outcome.detail:
                values["detail"] = outcome.detail
        line = json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                           "values": values, "s": round(time.perf_counter() - t, 1)})
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
