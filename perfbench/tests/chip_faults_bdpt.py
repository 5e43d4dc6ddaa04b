"""Faults of BDPT's t=1 splats, planted under the timed path of the
``sphere_field.bdpt`` cell, and a run of the cell with one of them at its
own size, for reading a fault's numbers on the card:

    python3 -m perfbench.tests.chip_faults_bdpt --fault splats_dropped \\
        --seeds a,b,c --seconds 10

One JSON line a seed with the compared numbers; ``correct`` must be false.
The CPU tests plant the same faults (``plant``)."""
from __future__ import annotations

import argparse
import json
import sys

import pytest

FAULTS = ("splats_dropped", "splats_mirrored")


def plant(mp, fault: str):
    """Patch the program's BDPT in this process: its t=1 splats left out of
    the film (``splats_dropped``), or sent to the pixel of the mirrored
    row (``splats_mirrored``: row y to row H - 1 - y)."""
    import torch

    from mcrt_tpu_torch.integrators import bdpt

    if fault == "splats_dropped":
        mp.setattr(bdpt, "_splat", lambda L, flat, contrib: L)
        return
    base = bdpt._family_t1

    def mirrored(scene, camera, cam, light, light_bsdfs, pairs, cfg, n, film, slot_of_pixel):
        w, h = film
        flip = torch.arange(w * h, device=slot_of_pixel.device).reshape(h, w).flip(0).reshape(-1)
        return base(scene, camera, cam, light, light_bsdfs, pairs, cfg, n, film,
                    slot_of_pixel[flip])
    mp.setattr(bdpt, "_family_t1", mirrored)


def main(argv=None) -> int:
    from perfbench.run import run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", required=True, choices=FAULTS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    mp = pytest.MonkeyPatch()
    plant(mp, args.fault)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = run_cell("sphere_field.bdpt", seed, args.seconds, False)
            print(json.dumps({"seed": seed, "fault": args.fault, "correct": r["correct"],
                              "values": r["notes"]["values"]}), flush=True)
    finally:
        mp.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
