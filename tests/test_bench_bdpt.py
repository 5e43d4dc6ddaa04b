"""The ``sphere_field.bdpt`` cell of the benchmark (``perfbench/``) on the
CPU, at a small size: the port's ``Renderer`` under BDPT against the
benchmark's plain BDPT reference (``perfbench/reference/integrators/
bdpt.py``), the reference's s = 1 strategies against its own path tracer,
and the cell's check against the bfloat16 control and faults of the t = 1
splats.

The cell runs through ``perfbench.run.run_cell`` with the CUDA device
replaced by the CPU, where the intersector runs its kernels' plain
versions.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import checks, manifest, scenes  # noqa: E402
from perfbench.control import control_values  # noqa: E402
from perfbench.run import BANNED, run_cell  # noqa: E402
from perfbench.tests import chip_faults_bdpt  # noqa: E402

CELL = "sphere_field.bdpt"
SEEDS = (2**31 + 7, 12345678901)


def _small(width: int, depth: int) -> dict:
    return {"render": {"width": width, "height": width},
            "traffic": {"check_pixels": 64, "warm_frames": 1, "trace_frames": 2,
                        "integrator": {"type": "bdpt", "max_depth": depth}}}


def _run(width=16, depth=3, seed=SEEDS[0], seconds=1.0, trace=False):
    return run_cell(CELL, seed, seconds, trace, device="cpu", overrides=_small(width, depth))


@pytest.mark.parametrize("width, depth, seed", [(16, 3, SEEDS[0]), (16, 3, SEEDS[1]),
                                                (8, 8, SEEDS[0]), (8, 8, SEEDS[1])])
def test_port_bdpt_is_correct_against_the_reference(width, depth, seed):
    r = _run(width, depth, seed)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["notes"]["values"]["frames_missing"] == 0
    # the image is lit: a check of zeros against zeros would hold nothing
    assert r["notes"]["ref_mean"] > 0.01
    assert set(r["metrics"]) == {"spp_ms", "frame_ms_p90", "peak_mem_gib", "setup_s"}


def test_a_traced_run_reads_the_bdpt_metrics():
    """The traced run's line carries the BDPT stage's host ops and idle
    share, read from the program's ``mcrt.bdpt.*`` spans (on the CPU no
    device op is traced, so the device metrics read nothing)."""
    r = _run(8, 2, trace=True)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["bdpt.ops_per_spp"]["value"] > 0
    assert "bdpt.idle_share" in r["metrics"]


@pytest.mark.parametrize("fault", chip_faults_bdpt.FAULTS)
def test_splat_fault_is_caught(monkeypatch, fault):
    chip_faults_bdpt.plant(monkeypatch, fault)
    r = _run()
    assert r["correct"] is False, r["checks"]


def test_bfloat16_control_is_not_correct():
    values = control_values(CELL, 2**31 + 3, 3, device="cpu", overrides=_small(16, 3))
    assert not checks.passed(checks.judge(values, manifest.limits(CELL))), values


def test_the_cell_reports_its_metrics():
    man = manifest.load()
    assert manifest.workload(man, CELL)["chips"] == 1
    assert {m["name"] for m in manifest.end_to_end(man, CELL)} == {"spp_ms", "frame_ms_p90",
                                                                   "peak_mem_gib", "setup_s"}
    layers = {m["name"] for m in manifest.per_layer(man, CELL)}
    assert {"bdpt.ops_per_spp", "bdpt.idle_share", "bdpt.shadow_ms_per_spp",
            "queries_roofline", "frame.launches_per_spp"} <= layers
    assert not any(name.startswith("shade.") for name in layers)
    assert manifest.traffic("bdpt")["integrator"] == {"type": "bdpt", "max_depth": 8}


@pytest.mark.parametrize("depth", [1, 3])
def test_reference_s1_strategies_are_its_path_tracers_nee(monkeypatch, depth):
    """The reference's s = 1 strategies, unweighted, are the reference path
    tracer's next-event estimate on the same lanes: the path tracer is
    handed, for its bounce i, BDPT's uniforms of the camera walk's step i
    (the BSDF sample) and of the s = 1 strategy at t = i + 2 (the light
    sample), and its emitter hits are zeroed."""
    from perfbench.reference import config as ref_config
    from perfbench.reference.camera import pinhole
    from perfbench.reference.core.types import Rays
    from perfbench.reference.integrators import bdpt, path
    from perfbench.reference.lights import lights
    from perfbench.reference.query import ClusterQuery
    from perfbench.reference.render import frame_jitter
    from perfbench.reference.sampling import rng
    from perfbench.reference.scene import scene as scene_mod, textures

    spec = scenes.load("sphere_field")
    sc, cam = scenes.assemble(spec, scene_mod, textures, pinhole, "cpu")
    query = ClusterQuery(spec.positions, spec.indices, spec.face_shape, "cpu")
    cfg = ref_config.from_dict({"width": 16, "height": 16, "sampler": {"type": "sobol"},
                                "integrator": {"max_depth": depth}})
    pix = torch.arange(256).repeat(2)
    fr = torch.tensor([1024] * 256 + [1025] * 256)
    jit = torch.as_tensor(frame_jitter([1024, 1025]))[fr - 1024]
    uv = torch.stack([((pix % 16).float() + 0.5) / 16, ((pix // 16).float() + 0.5) / 16], -1)
    o, d = cam.generate_rays(uv + jit / 16.0)
    with torch.no_grad():
        nee = bdpt.own_radiance(sc, cam, Rays.make(o, d), rng.make_stream(cfg.sampler, fr, pix),
                                cfg.integrator, query.intersect, query.occluded, s1_only=True)
        s1_dims = 3 * (depth + 1) + 5 + 3 * depth
        draw = rng._draw

        def bdpt_dims(stream, k):
            bounce, r = divmod(stream.dim, 6)
            start = {0: s1_dims + 3 * bounce, 1: s1_dims + 3 * bounce + 1, 3: 3 * bounce}[r]
            u, _ = draw(dataclasses.replace(stream, dim=start), k)
            return u, stream.advance(k)

        monkeypatch.setattr(rng, "_draw", bdpt_dims)
        monkeypatch.setattr(lights, "eval_le",
                            lambda scene, idx, n, wo: torch.zeros(idx.shape + (3,)))
        pt = path.trace(sc, Rays.make(o, d), rng.make_stream(cfg.sampler, fr, pix),
                        cfg.integrator, query.intersect, query.occluded,
                        diff=cam.generate_ray_differentials(uv + jit / 16.0, 16, 16))
    assert float(nee.sum()) > 0 and torch.isfinite(nee).all()
    torch.testing.assert_close(nee, pt, rtol=1e-5, atol=1e-6)


REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from perfbench import scenes
from perfbench.refside_bdpt import BDPTReference
render = {{"width": 8, "height": 8, "sampler": {{"type": "sobol"}},
          "integrator": {{"type": "bdpt", "max_depth": 2}}}}
img = BDPTReference().film(scenes.load("textured_hall"), render, torch.arange(64), [1024, 1025])
print(json.dumps([float(img.mean()), sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def test_the_bdpt_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", REFERENCE.format(root=ROOT)], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": ""}, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    mean, mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert mean > 0
    assert not set(mods) & (set(BANNED) | {"mcrt_tpu_torch"})
