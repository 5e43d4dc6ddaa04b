"""``BENCHMARK.json`` and the files its names lead to.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own, found by name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, which names the loop
  (``loops/<loop>.py``) that drives the window;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(record)`` returns
  a number or None;
- a cell's correctness limits: ``limits/<workload>.json``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    return _by_name(man["workloads"], name, "workload")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    entry = _by_name(man["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json("limits", f"{workload_name}.json")


def loop(name: str):
    return importlib.import_module(f"perfbench.loops.{name}")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, wl_name: str, reported=None) -> bool:
    if "workloads" in metric:
        return wl_name in metric["workloads"]
    return reported is None or metric["moves"] in reported


def end_to_end(man: dict, wl_name: str) -> list:
    """The end-to-end metrics cell ``wl_name`` reports."""
    return [m for m in man["end_to_end"] if _applies(m, wl_name)]


def per_layer(man: dict, wl_name: str) -> list:
    """The per-layer metrics cell ``wl_name`` reports: those that list it,
    and those without a list whose ``moves`` metric it reports."""
    reported = {m["name"] for m in end_to_end(man, wl_name)}
    return [m for m in man["per_layer"] if _applies(m, wl_name, reported)]
