"""BENCHMARK.json against the contract's names and limits, and every name
it gives resolved to its file."""
import json
import os
import re

import pytest

from perfbench import manifest

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["command"]) <= 32 and all(LINE.match(w) for w in MAN["command"])
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in MAN["paths"])
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    items = MAN[kind]
    names = [x["name"] for x in items]
    assert len(names) == len(set(names))
    for x in items:
        assert NAME.match(x["name"]), x["name"]
        if "unit" in x:
            assert UNIT.match(x["unit"]), x["unit"]
            assert x["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in x and kind in ("configs", "workloads", "per_layer"):
                assert LINE.match(x[key]), x[key]


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}


def test_four_chip_cells_within_cap():
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("wl", [w["name"] for w in MAN["workloads"]])
def test_workload_resolves_by_name(wl):
    """A cell's configuration, mix, loop, limits and metric readers are all
    found from the names in BENCHMARK.json alone."""
    w = manifest.workload(MAN, wl)
    cfg = manifest.config(MAN, w["config"])
    traffic = manifest.traffic(w["traffic"])
    assert hasattr(manifest.loop(traffic["loop"]), "run")
    assert manifest.limits(wl)
    assert cfg["precision"] == "float32" and {"source", "reduced", "assumed"} <= set(cfg)
    for k in cfg["reduced"]:
        assert k in cfg
    e2e = {m["name"] for m in manifest.end_to_end(MAN, wl)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.per_layer(MAN, wl)
    assert layers
    for m in layers:
        assert callable(manifest.reader(m["name"]))
        assert m["moves"] in e2e


def test_every_config_used_and_files_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p.rstrip("/") + "/") for p in MAN["paths"])
        with open(os.path.join(manifest.ROOT, f)) as fh:
            json.load(fh)


def test_file_names_under_paths():
    for p in MAN["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(manifest.ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                if f.endswith(".pyc"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, f), manifest.ROOT)
                assert PATH.match(rel), rel
