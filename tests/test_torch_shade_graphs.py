"""The progressive ``Renderer``'s shading graphs (``integrators.path.ShadeGraphs``)
on the CPU.

A CUDA graph runs only on a card, so here a stand-in takes its place: it
keeps the graph's output set and rewrites it in place on each replay, as
a replayed graph does.  With it the graphed runner of the bounce loop (the
copies into static inputs, the two output sets, the fresh masks handed to
the queries) is held bit-equal to the eager runner, and a scene changed
every frame is held to the eager runner.  The real graphs against the eager loop on the card:
``tests/test_torch_cuda.py::test_graphed_frames_equal_eager_frames``.
The graphs must never engage off their path: on the CPU, under autograd,
BDPT and RANDOM, and in ``render_spp_batch``, which is handed none.
"""
import pytest
import torch

from mcrt_tpu_torch import Renderer
from mcrt_tpu_torch.accel import Intersector
from mcrt_tpu_torch.config import (IntegratorConfig, IntegratorType, RenderConfig, SamplerConfig,
                                   SamplerType)
from mcrt_tpu_torch.integrators import path
from mcrt_tpu_torch.parallel.render import render_spp_batch
from mcrt_tpu_torch.renderer import render_frame_fn, render_sample
from mcrt_tpu_torch.scene.builders import cornell_box, textured_hall
from mcrt_tpu_torch.scene.dynamic import SceneAnimator, translation

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

SIZE, DEPTH, START = 16, 4, 1023


class StandInGraphs(path.ShadeGraphs):
    """``ShadeGraphs`` that captures on the CPU and replays a bounce by
    running its body again and copying the result into the output set of
    the capture, whose tensors every later reader holds."""

    device_type = "cpu"

    def _capture(self, body, keep, device):
        body()  # the warm-up
        return (lambda: keep(body())), keep(body())


def _cfg(sampler=SamplerType.SOBOL, integrator=IntegratorType.PATH, **kw):
    return RenderConfig(width=SIZE, height=SIZE, sampler=SamplerConfig(type=sampler),
                        integrator=IntegratorConfig(type=integrator, max_depth=DEPTH, **kw))


def _renderer(builder, cfg, graphs):
    r = Renderer(*builder(device="cpu"), cfg, device="cpu")
    r._shade_graphs = graphs
    r.accum = r.accum.replace(frame=START)
    return r


def _eager(r, accum, frames):
    """``frames`` eager frames of ``r``'s scene from ``accum``."""
    with torch.no_grad():
        for _ in range(frames):
            accum = render_frame_fn(r.scene, r.camera, accum, accum.frame, r.cfg, r.intersector)
    return accum


def _recording(intersector, masks):
    """``intersector`` keeping each query's ``active`` mask, as a traced
    run's wrapper does."""
    def wrap(fn):
        def run(s, rays):
            masks.append(rays.active)
            return fn(s, rays)
        return run

    return Intersector(wrap(intersector.intersect), wrap(intersector.occluded),
                       intersector.accel)


@pytest.mark.parametrize("builder, shadows", [(cornell_box, True), (textured_hall, True),
                                              (cornell_box, False)],
                         ids=["cornell_box", "textured_hall", "no_shadows"])
def test_graphed_loop_equals_eager_loop(builder, shadows):
    """Three frames, the first eager and the next two graphed, equal three
    eager frames bit for bit, and the masks a query was handed keep their
    frame's values after later replays; the bounces' outputs take two sets
    of tensors, alternating; after ``update_scene`` the first frame runs
    eagerly again, the next captures anew, and they still equal."""
    r = _renderer(builder, _cfg(enable_shadows=shadows), StandInGraphs())
    for round_ in (1, 2):
        start = r.accum
        graphed, eager = [], []
        base = r.intersector
        r.intersector = _recording(base, graphed)
        r.step(3)
        r.intersector = _recording(base, eager)
        want = _eager(r, start, 3)
        r.intersector = base
        assert torch.equal(r.accum.weighted, want.weighted)
        assert len(graphed) == len(eager) == 3 * DEPTH * (2 if shadows else 1)
        assert [int(m.sum()) for m in graphed] == [int(m.sum()) for m in eager]
        assert r.shade_graph_stats() == {"captures": DEPTH * round_, "replays": 2 * DEPTH * round_,
                                         "eager_bounces": DEPTH * round_}
        outs = [path._tensors(b[2]) for b in r._shade_graphs._bounces]
        assert all(all(a is b for a, b in zip(outs[k], outs[k + 2])) for k in range(DEPTH - 2))
        assert len({t.data_ptr() for o in outs for t in o}) == 2 * len(outs[0])
        moved = SceneAnimator.create(r.scene).set_transform(0, translation((0.05, 0.0, 0.0)))
        r.update_scene(moved)


def test_scene_changed_every_frame_never_captures():
    """A shape moved through ``update_scene`` before each frame, as an
    animation or a viewer edit does: every frame runs eagerly (a capture
    would cost each of them a host sync and eight captures) and equals the
    eager render of its scene."""
    r = _renderer(cornell_box, _cfg(), StandInGraphs())
    anim = SceneAnimator.create(r.scene)
    for k in range(1, 4):
        r.update_scene(anim.set_transform(0, translation((0.05 * k, 0.0, 0.0))))
        start = r.accum
        r.step(1)
        assert torch.equal(r.accum.weighted, _eager(r, start, 1).weighted)
    assert r.shade_graph_stats() == {"captures": 0, "replays": 0, "eager_bounces": 3 * DEPTH}


def _spy_trace(monkeypatch):
    """Records the graphs that every ``path.trace`` call would replay
    through (``path.replaying``'s)."""
    seen, trace = [], path.trace

    def spy(*a, **kw):
        seen.append(path._REPLAYING.get())
        return trace(*a, **kw)

    monkeypatch.setattr(path, "trace", spy)
    return seen


@pytest.mark.parametrize("case", ["cpu_renderer", "render_spp_batch", "autograd", "bdpt",
                                  "random"])
def test_graphs_never_engage_off_their_path(case, monkeypatch):
    """Each caller that must run eagerly does, with the stand-in taking the
    CPU for a card where a ``Renderer`` is involved: no capture, no replay,
    the image equal to the eager render's.  A CPU ``Renderer`` with its own
    graphs counts its bounces as eager; ``render_spp_batch`` traces with
    no graphs; a frame under autograd, BDPT and RANDOM keep the eager loop
    inside ``replaying`` the stand-in."""
    integrator = IntegratorType.BDPT if case == "bdpt" else IntegratorType.PATH
    sampler = SamplerType.RANDOM if case == "random" else SamplerType.SOBOL
    cfg = _cfg(sampler, integrator)
    graphs = path.ShadeGraphs() if case == "cpu_renderer" else StandInGraphs()
    r = _renderer(cornell_box, cfg, graphs)
    start = r.accum
    if case == "render_spp_batch":
        seen = _spy_trace(monkeypatch)
        with torch.no_grad():
            got = render_spp_batch(r.scene, r.camera, [START, START + 1], cfg, r.intersector)
            assert len(seen) == 2 and all(g is None for g in seen)
            want = torch.stack([render_sample(r.scene, r.camera, f, cfg, r.intersector)[0]
                                for f in (START, START + 1)]).mean(0)
        assert torch.equal(got, want)
        return
    if case == "autograd":
        diffuse = r.scene.materials.diffuse.clone().requires_grad_(True)
        r.scene = r.scene.replace(materials=r.scene.materials.replace(diffuse=diffuse))
        with torch.enable_grad(), path.replaying(graphs):
            got = render_frame_fn(r.scene, r.camera, start, START, cfg, r.intersector)
        assert got.weighted.requires_grad
        got_w = got.weighted.detach()
    else:
        r.step(2)
        got_w = r.accum.weighted
    want = _eager(r, start, 1 if case == "autograd" else 2)
    assert torch.equal(got_w, want.weighted)
    stats = graphs.stats()
    assert stats["captures"] == stats["replays"] == 0
    frames = 1 if case == "autograd" else 2
    assert stats["eager_bounces"] == (0 if case == "bdpt" else frames * DEPTH)
