"""A cell's run with a fault planted under its timed path, at the cell's own
size, for reading a fault's numbers on the card:

    python3 -m perfbench.tests.chip_faults --workload sphere_field.grad \\
        --fault half_the_batch --seeds a,b,c --seconds 2

One JSON line a seed with the compared numbers; ``correct`` must be false."""
from __future__ import annotations

import argparse
import json
import sys

import pytest

from perfbench.run import run_cell
from perfbench.tests import test_bench_faults as tf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=tf.FAULTS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    plant = tf._grad_fault if args.workload.endswith(".grad") else tf._progressive_fault
    mp = pytest.MonkeyPatch()
    plant(mp, args.fault)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = run_cell(args.workload, seed, args.seconds, False)
            print(json.dumps({"seed": seed, "fault": args.fault, "correct": r["correct"],
                              "values": r["notes"]["values"]}), flush=True)
    finally:
        mp.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
