"""The port's program spans and live-ray counter (``utils/profiling.py``:
``span``, ``tally``, ``tallies``) on the CPU.

Under ``torch.profiler`` a step exports one ``mcrt.*`` range for each stage
of a frame, each inside the one that caused it; with no profiler recording
a span is one shared null context and no ``record_function`` is entered.
The live-ray tally equals the queries' ``active`` masks summed apart, and a
frame's film is the same bits traced or not.  ``tools/profile_frame.py``'s
trace readers are held on the same CPU traces.
"""
import json
import os
import tempfile
from collections import Counter

import pytest
import torch

from mcrt_tpu_torch import RenderConfig, Renderer
from mcrt_tpu_torch.accel import Intersector, build_intersector
from mcrt_tpu_torch.config import IntegratorConfig, IntegratorType
from mcrt_tpu_torch.diff import estimators as E
from mcrt_tpu_torch.parallel.mesh import spawn_ranks
from mcrt_tpu_torch.parallel.render import render_spp_batch
from mcrt_tpu_torch.scene import builders
from mcrt_tpu_torch.tools import profile_frame
from mcrt_tpu_torch.utils import profiling

torch.set_num_threads(1)

SIZE, DEPTH = 8, 2
# cornell_box takes the dense path (K4/K5's plain versions, no cull),
# glass_gallery's 31 blocks the visit-list path; two samples a pass there
SCENES = {"cornell_box": 1, "glass_gallery": 2}
QUERY_STAGES = ("mcrt.query.sort", "mcrt.query.cull", "mcrt.query.walk",
                "mcrt.query.resolve")


def _cfg(integrator="PATH", samples_per_pass=1):
    return RenderConfig(width=SIZE, height=SIZE, samples_per_pass=samples_per_pass,
                        integrator=IntegratorConfig(type=IntegratorType[integrator],
                                                    max_depth=DEPTH))


def _renderer(scene_name, integrator="PATH"):
    scene, camera = getattr(builders, scene_name)(device="cpu")
    return Renderer(scene, camera, _cfg(integrator, SCENES[scene_name]), device="cpu")


def _spans(run):
    """``run()`` under ``torch.profiler`` (CPU activity): its ``mcrt.*``
    ranges as (name, start, end), sorted by start."""
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("mcrt."))


def _inside(spans, child, *parents):
    """Whether every ``child`` span lies inside a span named in ``parents``."""
    outer = [(s, e) for n, s, e in spans if n in parents]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer)
               for n, s, e in spans if n == child)


@pytest.fixture(scope="module")
def traced_steps():
    """{scene: the spans of one traced ``Renderer.step(1)``}, after an
    untraced warm-up step."""
    out = {}
    for name in SCENES:
        r = _renderer(name)
        r.step(1)
        out[name] = _spans(lambda: r.step(1))
        profiling.tallies()
    return out


@pytest.mark.parametrize("scene_name", SCENES)
def test_frame_camera_and_film_once_a_sample(traced_steps, scene_name):
    spans, samples = traced_steps[scene_name], SCENES[scene_name]
    counts = Counter(n for n, _, _ in spans)
    assert counts["mcrt.frame"] == 1
    assert counts["mcrt.camera"] == counts["mcrt.film"] == samples
    assert _inside(spans, "mcrt.camera", "mcrt.frame")
    assert _inside(spans, "mcrt.film", "mcrt.frame")


@pytest.mark.parametrize("scene_name", SCENES)
def test_shading_and_queries_once_a_bounce_in_the_frame(traced_steps, scene_name):
    spans, samples = traced_steps[scene_name], SCENES[scene_name]
    counts = Counter(n for n, _, _ in spans)
    for name in ("mcrt.shade", "mcrt.query.closest", "mcrt.query.occluded"):
        assert counts[name] == DEPTH * samples, name
        assert _inside(spans, name, "mcrt.frame"), name


@pytest.mark.parametrize("scene_name", SCENES)
def test_shade_parts_inside_shade(traced_steps, scene_name):
    spans, samples = traced_steps[scene_name], SCENES[scene_name]
    counts = Counter(n for n, _, _ in spans)
    for part in ("interaction", "nee", "bsdf"):
        assert counts[f"mcrt.shade.{part}"] == DEPTH * samples
        assert _inside(spans, f"mcrt.shade.{part}", "mcrt.shade")


@pytest.mark.parametrize("scene_name", SCENES)
def test_query_stages_inside_the_queries(traced_steps, scene_name):
    """Every blocked query sorts (or packs), walks and resolves; only the
    visit-list path culls."""
    spans, samples = traced_steps[scene_name], SCENES[scene_name]
    counts = Counter(n for n, _, _ in spans)
    queries = 2 * DEPTH * samples
    culled = scene_name != "cornell_box"
    for stage in QUERY_STAGES:
        assert counts[stage] == (queries if culled or stage != "mcrt.query.cull" else 0)
        assert _inside(spans, stage, "mcrt.query.closest", "mcrt.query.occluded")


def test_bdpt_step_opens_the_seven_stage_spans():
    r = _renderer("cornell_box", "BDPT")
    spans = _spans(lambda: r.step(1))
    profiling.tallies()
    counts = Counter(n for n, _, _ in spans)
    for stage in profile_frame.BDPT_STAGES:
        assert counts[f"mcrt.bdpt.{stage}"] == 1, stage
        assert _inside(spans, f"mcrt.bdpt.{stage}", "mcrt.frame")
    # the walks' closest-hit queries lie inside them
    assert _inside(spans, "mcrt.query.closest", "mcrt.bdpt.camera_walk",
                   "mcrt.bdpt.light_walk")


def test_bdpt_occlusion_span_holds_the_chunked_queries():
    """The staging and the chunked occlusion queries lie in one
    ``mcrt.bdpt.occlusion`` span a frame, and the host count of the staged
    shadow rays is the staged table's size: every strategy that takes a
    shadow ray, a ray a lane."""
    from mcrt_tpu_torch.integrators import bdpt

    r = _renderer("cornell_box", "BDPT")
    r.step(1)
    profiling.counts()
    spans = _spans(lambda: r.step(1))
    live = profiling.tallies()
    counts = Counter(n for n, _, _ in spans)
    assert counts["mcrt.bdpt.occlusion"] == 1
    assert _inside(spans, "mcrt.bdpt.occlusion", "mcrt.frame")
    assert counts["mcrt.query.occluded"] >= 1
    assert _inside(spans, "mcrt.query.occluded", "mcrt.bdpt.occlusion")
    _, s1, conn, t1 = bdpt.strategy_pairs(DEPTH)
    staged = profiling.counts()
    assert staged["bdpt.staged_rays"] == (len(s1) + len(conn) + len(t1)) * SIZE * SIZE
    assert staged["bdpt.occlusion_chunks"] == counts["mcrt.query.occluded"]
    assert 0 < live["rays.occluded"] <= staged["bdpt.staged_rays"]
    assert profiling.counts() == {}  # cleared once read


def test_bdpt_counts_nothing_without_a_profiler():
    r = _renderer("cornell_box", "BDPT")
    profiling.counts()
    r.step(1)
    assert profiling.counts() == {}


def test_render_spp_batch_without_a_mesh_opens_the_camera():
    scene, camera = builders.cornell_box(device="cpu")
    cfg = _cfg()
    isect = build_intersector(scene, cfg)
    with torch.no_grad():
        spans = _spans(lambda: render_spp_batch(scene, camera, [0, 1], cfg, isect))
    profiling.tallies()
    counts = Counter(n for n, _, _ in spans)
    assert counts["mcrt.camera"] == 2
    assert counts["mcrt.frame"] == counts["mcrt.film"] == 0


def test_the_loss_encloses_a_gradient_step_forward():
    scene, camera = builders.cornell_box(device="cpu")
    cfg = _cfg()
    isect = build_intersector(scene, cfg)
    view = E.material_params()
    loss_fn = E.render_loss_fn(camera, cfg, isect, view)
    target = torch.zeros((SIZE * SIZE, 3))
    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}

    def step():
        loss_fn(params, scene, [0], target).backward()

    spans = _spans(step)
    profiling.tallies()
    counts = Counter(n for n, _, _ in spans)
    assert counts["mcrt.loss"] == 1
    for name in ("mcrt.camera", "mcrt.shade", "mcrt.query.closest"):
        assert counts[name] >= 1 and _inside(spans, name, "mcrt.loss")


def rank_spans(rank, out_dir):
    """One sharded batch on a (2, 1) mesh under the profiler: this rank's
    span counts and whether the camera lies inside the local part."""
    from mcrt_tpu_torch.parallel.mesh import make_mesh

    scene, camera = builders.cornell_box(device="cpu")
    cfg = _cfg()
    isect = build_intersector(scene, cfg)
    mesh = make_mesh(2, 1, device="cpu")
    with torch.no_grad():
        spans = _spans(lambda: render_spp_batch(scene, camera, [0, 1], cfg, isect, mesh))
    profiling.tallies()
    torch.save({"counts": Counter(n for n, _, _ in spans),
                "camera_in_local": _inside(spans, "mcrt.camera", "mcrt.dist.local")},
               os.path.join(out_dir, f"rank{rank}.pt"))


def test_sharded_batch_opens_the_local_part_and_the_all_reduce(tmp_path):
    spawn_ranks(rank_spans, 2, args=(str(tmp_path),), device="cpu",
                init_method=f"file://{tmp_path}/store", timeout=300)
    for rank in range(2):
        out = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        assert out["counts"]["mcrt.dist.local"] == 1
        assert out["counts"]["mcrt.dist.all_reduce"] == 1
        assert out["counts"]["mcrt.camera"] == 1 and out["camera_in_local"]


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = profiling.span("mcrt.frame"), profiling.span("mcrt.shade")
    assert a is b
    with a:
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.span("mcrt.frame") is not a
    assert profiling.span("mcrt.frame") is a


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    r = _renderer("glass_gallery")

    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    r.step(1)
    assert r.accum.frame == SCENES["glass_gallery"]
    assert profiling.tallies() == {}


def _counting(base, seen):
    """``base`` with each query's ``active`` mask summed apart into ``seen``."""

    def wrap(fn, kind):
        def run(s, rays):
            seen[kind] += int(rays.active.sum())
            return fn(s, rays)
        return run

    return Intersector(wrap(base.intersect, "rays.closest"),
                       wrap(base.occluded, "rays.occluded"), base.accel)


@pytest.mark.parametrize("integrator", ["PATH", "BDPT"])
def test_tallies_equal_the_active_masks_summed_apart(integrator):
    r = _renderer("glass_gallery", integrator)
    seen = Counter()
    r.intersector = _counting(r.intersector, seen)
    profiling.tallies()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.step(1)
    live = profiling.tallies()
    assert live == dict(seen) and live["rays.closest"] > 0 and live["rays.occluded"] > 0
    assert profiling.tallies() == {}  # cleared once read


def test_tallies_are_empty_without_a_profiler():
    r = _renderer("cornell_box")
    profiling.tallies()
    r.step(1)
    assert profiling.tallies() == {}


def test_an_unread_recording_is_dropped_by_the_next_query():
    """A recording whose tallies nobody reads holds its masks only until
    the first query outside a recording."""
    r = _renderer("cornell_box")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.step(1)
    assert profiling._tallies
    r.step(1)
    assert not profiling._tallies and profiling.tallies() == {}


def test_tally_folds_a_long_recording(monkeypatch):
    """Past ``_FOLD`` masks a name, the kept masks fold into one count."""
    monkeypatch.setattr(profiling, "_FOLD", 3)
    masks = [torch.rand(50, generator=torch.Generator().manual_seed(i)) > 0.5
             for i in range(7)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for m in masks:
            profiling.tally("rays.closest", m)
    assert len(profiling._tallies["rays.closest"]) < 3
    assert profiling.tallies() == {"rays.closest": int(sum(int(m.sum()) for m in masks))}


@pytest.mark.parametrize("scene_name", SCENES)
def test_film_is_bit_equal_traced_or_not(scene_name):
    plain, traced = _renderer(scene_name), _renderer(scene_name)
    plain.step(1)
    _spans(lambda: traced.step(1))
    profiling.tallies()
    assert torch.equal(plain.accum.weighted, traced.accum.weighted)
    assert torch.equal(plain.accum.weight, traced.accum.weight)


@pytest.mark.parametrize("recording", [False, True])
def test_profiler_span_nests_counts_and_survives_an_exception(recording):
    prof = profiling.Profiler()

    def body():
        with pytest.raises(RuntimeError):
            with prof.span("outer"):
                with prof.span("inner"):
                    raise RuntimeError("inside")
        with prof.span("outer"):
            pass

    if recording:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            body()
        names = Counter(e.name for e in p.events())
        assert names["outer"] == 2 and names["inner"] == 1
    else:
        body()
    stats = prof.stats()
    assert set(stats) == {"outer", "outer/inner"}
    assert stats["outer"].count == 2 and stats["outer/inner"].count == 1


def test_profile_frame_reads_the_spans_of_a_trace():
    """``profile_frame``'s stage lines from a CPU trace: one line a bounce,
    each with the closest-hit query, shading and the shadow query."""
    r = _renderer("glass_gallery")
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            r.step(1)
        (path,) = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    profiling.tallies()
    spans, device = profile_frame.read_trace(events)
    assert device == []
    assert len(spans["mcrt.shade"]) == DEPTH * SCENES["glass_gallery"]
    assert all(host > 0 and dev == 0 for host, dev in spans["mcrt.frame"])
    lines = profile_frame.stage_lines(spans, "path")
    bounces = [ln for ln in lines if ln.startswith("bounce ")]
    assert len(bounces) == DEPTH * SCENES["glass_gallery"]
    assert all(("query.closest" in ln and "shade" in ln and "query.occluded" in ln)
               for ln in bounces)
    queries = 2 * DEPTH * SCENES["glass_gallery"]
    assert f"mcrt.query.cull: {queries} spans" in [ln.split(",")[0] for ln in lines]


def test_profile_frame_busy_time_is_a_union():
    # two overlapping kernels on two streams count once: busy 0-4 and 6-7 us
    device = [("a", 0.0, 3.0), ("b", 1.0, 3.0), ("c", 6.0, 1.0), ("d", 6.5, 0.2)]
    assert profile_frame.busy_ms(device) == pytest.approx(5e-3)
    assert profile_frame.busy_ms([]) == 0.0
