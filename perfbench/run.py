"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``mcrt_tpu_torch``.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and a breakdown.  It needs as many CUDA devices as the cell asks for and
exits with a nonzero code, printing no result, where it finds fewer, or
where a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "mcrt_tpu")


def banned_modules() -> list:
    """Top-level names of loaded modules that a run must not load, each
    compared whole (``mcrt_tpu_torch`` is not ``mcrt_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def _finite(obj):
    """``obj`` with every float that is not finite as None: the line is
    strict JSON."""
    if isinstance(obj, float):
        return obj if obj == obj and obj not in (float("inf"), float("-inf")) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             overrides: dict | None = None) -> dict:
    """One run of cell ``name``: the result line as a dict.  ``device``
    defaults to the CUDA card; ``overrides`` replaces keys of the
    configuration's ``render`` and of the traffic mix (the CPU tests run a
    cell at a small size)."""
    import torch

    from perfbench import checks, manifest, scenes, trace as trace_mod
    from perfbench.refside import Reference

    man = manifest.load()
    wl = manifest.workload(man, name)
    cfg = manifest.config(man, wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    limits = manifest.limits(name)
    overrides = overrides or {}
    cfg["render"] = {**cfg["render"], **overrides.get("render", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    dev = torch.device(device or "cuda")
    ctx = SimpleNamespace(
        seed=int(seed), seconds=float(seconds), trace=bool(trace), config=cfg,
        traffic=traffic, chips=int(wl["chips"]), device=dev,
        t_start=T_START, spec=scenes.load(cfg["scene"], cfg.get("scene_args")),
        reference=Reference())
    out = manifest.loop(traffic["loop"]).run(ctx)

    if trace:
        rec = out.record
        metrics = {}
        for m in manifest.per_layer(man, name):
            value = manifest.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(man, name)}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": ctx.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": False, "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = out.record.busy_s
        device_info["window_s"] = out.record.window_s
        result["breakdown"] = {"device_ops": trace_mod.top_device_ops(out.record),
                               "idle_gaps": trace_mod.idle_by_host_op(out.record)}
    judged = checks.judge(out.values, limits)
    result["correct"] = checks.passed(judged) and out.failed == 0
    result["notes"] = {"values": out.values, **out.notes}
    result["checks"] = judged  # last: the numbers compared, each beside its limit
    return _finite(result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = "1"  # one process, one host thread of CPU ops
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    torch.set_num_threads(1)

    from perfbench import manifest

    chips = int(manifest.workload(manifest.load(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
