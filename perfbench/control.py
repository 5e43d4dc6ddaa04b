"""The control of a cell's check: the plain reference, computed in the
precision below the one the configuration states (``BELOW``), put in the
program's place, at the cell's own size.  It has to come out not correct.

    python3 perfbench/control.py --workload <name> --seeds <a,b,c> --work <n>

``--work`` is the window's work to compare: frames for a progressive cell,
batches for a sharded one (the gradient cell always compares its first
three steps).  One JSON line a seed: the numbers beside their limits.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BELOW = {"float32": "bfloat16"}  # a configuration's precision -> its control's


def control_values(name: str, seed: int, work: int, device=None, overrides=None) -> dict:
    import torch

    from perfbench import manifest, scenes
    from perfbench.refside import Reference

    man = manifest.load()
    wl = manifest.workload(man, name)
    cfg = manifest.config(man, wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    overrides = overrides or {}
    cfg["render"] = {**cfg["render"], **overrides.get("render", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    ctx = SimpleNamespace(seed=int(seed), config=cfg, traffic=traffic, chips=int(wl["chips"]),
                          device=torch.device(device or "cuda"),
                          spec=scenes.load(cfg["scene"], cfg.get("scene_args")),
                          reference=Reference())
    low = Reference(BELOW[cfg["precision"]])
    return manifest.loop(traffic["loop"]).control(ctx, low, work)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--work", type=int, required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import checks, manifest

    limits = manifest.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        values = control_values(args.workload, seed, args.work)
        judged = checks.judge({k: values[k] for k in limits}, limits)
        print(json.dumps({"seed": seed, "correct":
                          checks.passed(judged), "seconds": time.perf_counter() - t,
                          "values": values, "checks": judged}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
