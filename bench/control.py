#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the reference,
put in the program's place with one stated guarantee broken (each
session's last feed left out of its count, ``systems.ControlSystem``), run
through the cell's own traffic and the run's own comparison. Its readings
have to fail a limit, or the comparison could not tell a wrong count from
a right one. The benchmark's runs never run it.

    python3 bench/control.py --workload ny_road.streams8 --seeds 11 12 13 --seconds 10

Prints one line of readings a seed: the numbers the run compares, and
whether ``correct`` came out false.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()

    from bench import harness
    from bench.systems import ControlSystem

    for seed in args.seeds:
        t = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                               system_cls=ControlSystem,
                               log=lambda msg: print(msg, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "checks": {k: c["value"] for k, c in out["checks"].items()},
                          "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
