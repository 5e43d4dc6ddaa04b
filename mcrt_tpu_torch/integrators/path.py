"""Unidirectional wavefront path integrator (counterpart of
``mcrt_tpu/integrators/path.py``).

Each bounce runs one closest-hit query over the whole wavefront, shades
every lane (emitter-hit accounting, next-event estimation with a uniform
light pick, BSDF sampling and the geometric-offset spawn), then one any-hit
query for the NEE shadow rays, whose contribution is added once visibility
is known.  The bounce loop is a Python loop, written with ``torch.where``
and without in-place writes, so that autograd differentiates it: inverse
rendering (``diff/``) runs it with gradients on, the progressive
``Renderer`` under ``torch.no_grad()``.

The progressive ``Renderer`` renders its frames inside ``replaying(graphs)``
with its ``ShadeGraphs``: there, where the wavefront is on a card, the
sampler is Sobol and autograd is off, each bounce's shading replays as one
CUDA graph between the two queries, which stay eager, once a wavefront of
the same scene, lane count, config and seeds has run before (the first
runs eagerly).  Every other caller (gradients, the sharded
``render_spp_batch``, BDPT, RANDOM, the CPU) runs the same loop with
each bounce's shading run as it is called.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Callable

import torch

from ..bsdf import uber
from ..bsdf.materials import fetch_bsdf
from ..config import IntegratorConfig
from ..core import math as m
from ..core.types import Rays, TensorRecord, Throughput
from ..lights import lights as lt
from ..sampling import rng, samplers as smp
from ..scene.interaction import compute_interaction, spawn_ray, spawn_shadow_ray
from ..scene.scene import Scene
from ..utils.profiling import span

IntersectFn = Callable[[Scene, Rays], object]
OccludedFn = Callable[[Scene, Rays], torch.Tensor]


def _shade(scene, cfg, i, rays, hit, tp, stream, prev_pdf, prev_p,
           bounce_diff=None):
    """Shading stage of one bounce.  The NEE contribution is returned, not
    yet added: the caller adds it where the shadow ray is unblocked.
    Returns ``(new_rays, tp, stream, new_prev_pdf, new_prev_p, srays,
    contrib, nee_ok)``."""
    with span("mcrt.shade.interaction"):
        alive = tp.active & hit.valid

        it = compute_interaction(scene, rays, hit, diff=bounce_diff)
        bsdf, it = fetch_bsdf(scene, it)

        t_f, b_f, n_f = it.dpdu, it.dpdv, it.ns
        wo_l = m.to_local(t_f, b_f, n_f, it.wo)

        # emitter hit: counted at bounce 0 or after a specular bounce, or
        # MIS-weighted against NEE when cfg.use_mis
        hit_light = alive & (it.light >= 0)
        le = lt.eval_le(scene, it.light, it.ns, it.wo)
        first_or_spec = tp.specular_bounce | (i == 0)
        if cfg.use_mis:
            num_l = float(max(scene.lights.num, 1))
            pdf_light = lt.pdf_li(scene, it.light, prev_p, rays.d, it.p, it.ns) / num_l
            w_mis = torch.where(first_or_spec, 1.0,
                                smp.power_heuristic(1.0, prev_pdf, 1.0, pdf_light))
            emit_w = torch.where(hit_light, w_mis, 0.0)
        else:
            emit_w = torch.where(hit_light & first_or_spec, 1.0, 0.0)
        radiance = tp.radiance + tp.beta * le * emit_w[..., None]

    with span("mcrt.shade.nee"):
        u_pick, stream = rng.next_1d(stream)
        u_light, stream = rng.next_2d(stream)
        u_bsdf, stream = rng.next_3d(stream)

        can_nee = alive & bsdf.has_non_delta() & (scene.lights.num > 0)
        l_idx, pdf_choice = lt.pick_light(scene.lights, u_pick)
        ls = lt.sample_li(scene, l_idx, it.p, u_light)
        wi_l = m.to_local(t_f, b_f, n_f, ls.wi)
        f_nee = uber.evaluate(bsdf, wo_l, wi_l)
        cos_i = torch.abs(m.dot(it.ns, ls.wi))
        # keep the light on the same geometric side as the reflection lobe
        front_ok = (m.dot(it.ng, ls.wi) * m.dot(it.ng, it.wo)) > 0.0
        nee_ok = can_nee & ls.valid & front_ok & ~m.is_black(f_nee)
        contrib = tp.beta * f_nee * ls.li * m.safe_div(cos_i, ls.pdf * pdf_choice)[..., None]
        if cfg.use_mis:
            pdf_b = uber.pdf(bsdf, wo_l, wi_l)
            w_nee = torch.where(ls.is_delta, 1.0,
                                smp.power_heuristic(1.0, ls.pdf * pdf_choice, 1.0, pdf_b))
            contrib = contrib * w_nee[..., None]
        srays = spawn_shadow_ray(it, ls.wi, ls.dist, cfg.trace_offset, nee_ok)

    with span("mcrt.shade.bsdf"):
        bs = uber.sample(bsdf, wo_l, u_bsdf)
        wi_w = m.to_world(t_f, b_f, n_f, bs.wi)
        cos_wi = torch.abs(m.dot(it.ns, wi_w))
        new_beta = tp.beta * (bs.f * m.safe_div(cos_wi, bs.pdf)[..., None])
        extend = alive & bs.valid & ~m.is_black(new_beta)

        if cfg.rr_start_depth > 0:
            # Russian roulette from rr_start_depth on: continue with probability
            # q = clamp(max beta component), survivors reweighted by 1/q
            u_rr, stream = rng.next_1d(stream)
            if i >= cfg.rr_start_depth:
                q = m.fclip(torch.amax(new_beta, dim=-1), 0.05, 1.0)
                new_beta = new_beta / q[..., None]
                extend = extend & (u_rr < q)

        new_rays = spawn_ray(it, wi_w, cfg.trace_offset, cfg.max_trace_distance, extend)
        tp = Throughput(
            beta=torch.where(extend[..., None], new_beta, tp.beta),
            radiance=radiance,
            specular_bounce=torch.where(extend, bs.is_specular, tp.specular_bounce),
            active=extend,
        )
        new_prev_pdf = torch.where(extend, bs.pdf, prev_pdf)
    return new_rays, tp, stream, new_prev_pdf, it.p, srays, contrib, nee_ok


def trace(scene: Scene, rays: Rays, stream: rng.SampleStream,
          cfg: IntegratorConfig, intersect: IntersectFn, occluded: OccludedFn,
          diff=None) -> torch.Tensor:
    """Trace one camera-sample wavefront to completion; returns (N, 3)
    radiance.  ``diff`` (camera-ray differentials) reaches only the primary
    bounce, as in the JAX package.  Each bounce's shading goes through a
    runner: inside ``replaying(graphs)`` the one ``graphs.runner`` picks,
    which may replay it as a CUDA graph, elsewhere one that runs it as it
    is called; the result is the same."""
    graphs = _REPLAYING.get()
    run = _Eager() if graphs is None else graphs.runner(scene, rays, stream, cfg)
    query_rays, prev = rays, None
    for i in range(cfg.max_depth):
        hit = intersect(scene, query_rays)
        with span("mcrt.shade"):
            if i == 0:
                out = run.shade(0, functools.partial(_first_bounce, scene, cfg, stream),
                                (hit, rays, diff, stream.pixel, stream.sobol_fold))
            else:
                out = run.shade(i, functools.partial(_next_bounce, scene, cfg, i, prev),
                                (hit, tp.radiance))
            rays, tp, stream, prev_pdf, prev_p, srays, contrib, nee_ok = out
            # neither the bounce's inputs nor its state before the NEE outlive
            # its shading: held on, they would raise a gradient step's peak memory
            out = prev = None
            query_rays = run.handed(rays)
            shadow_rays = run.handed(srays) if cfg.enable_shadows else None
        vis = nee_ok & ~occluded(scene, shadow_rays) if cfg.enable_shadows else nee_ok
        tp = tp.replace(radiance=tp.radiance + torch.where(vis[..., None], contrib, 0.0))
        prev = (rays, tp, stream, prev_pdf, prev_p)
    return tp.radiance


_REPLAYING: contextvars.ContextVar = contextvars.ContextVar("shade_graphs", default=None)


@contextlib.contextmanager
def replaying(graphs: "ShadeGraphs"):
    """Within the block, this thread's ``trace`` calls run their shading
    through ``graphs.runner`` (``Renderer.step`` opens it around its
    frames)."""
    token = _REPLAYING.set(graphs)
    try:
        yield graphs
    finally:
        _REPLAYING.reset(token)


def _first_bounce(scene, cfg, stream, hit, rays, diff, pixel, fold):
    """Bounce 0's shading from the camera rays, their differentials and the
    stream's per-frame tensors."""
    n = rays.n
    tp = Throughput.fresh(n, rays.o.device)
    prev_pdf = torch.ones((n,), dtype=torch.float32, device=rays.o.device)
    stream = stream.replace(pixel=pixel, sobol_fold=fold)
    return _shade(scene, cfg, 0, rays, hit, tp, stream, prev_pdf, rays.o, diff)


def _next_bounce(scene, cfg, i, prev, hit, radiance):
    """Bounce ``i``'s shading from the previous bounce's ``(rays, tp,
    stream, prev_pdf, prev_p)``, with ``radiance`` (the previous bounce's
    NEE added) as the throughput's radiance."""
    rays, tp, stream, prev_pdf, prev_p = prev
    return _shade(scene, cfg, i, rays, hit, tp.replace(radiance=radiance), stream,
                  prev_pdf, prev_p)


def _map(x, f):
    """``x``, a nest of tuples, records and tensors, with each tensor ``t``
    replaced by ``f(t)``, in ``_tensors``' order."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if isinstance(x, TensorRecord):
        return dataclasses.replace(x, **{fl.name: _map(getattr(x, fl.name), f)
                                         for fl in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_map(v, f) for v in x)
    return x


def _tensors(x) -> list[torch.Tensor]:
    """The tensors of a nest of tuples, records and tensors, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, TensorRecord):
        return [t for fl in dataclasses.fields(x) for t in _tensors(getattr(x, fl.name))]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


class _Eager:
    """``trace``'s runner off the graphs' path: a bounce's shading runs as
    it is called, and its rays go to the queries as they are.  ``graphs``,
    where given, counts the bounces."""

    def __init__(self, graphs: "ShadeGraphs | None" = None):
        self.graphs = graphs

    def shade(self, i: int, fn, fresh):
        if self.graphs is not None:
            self.graphs.eager_bounces += 1
        return fn(*fresh)

    @staticmethod
    def handed(rays: Rays) -> Rays:
        return rays


class ShadeGraphs:
    """CUDA graphs of ``trace``'s shading, one per bounce index (the index
    decides the primary bounce's terms, the camera differentials and
    Russian roulette), owned by the progressive ``Renderer``, and the
    runner that replays them.

    They hold the key of the wavefronts they were captured for: the scene,
    the number of lanes, the integrator config and the stream's seeds.  A
    wavefront of another key drops them and runs eagerly, so a scene that
    changes every frame (an animation, an edit in the viewer) never pays a
    capture; the next wavefront of the same key captures each bounce on
    its first use, after one eager warm-up on the capture stream, and every
    later one replays them.  A replay follows the bounce's closest-hit
    query: the hit, and at bounce 0 the camera rays, their differentials
    and the stream's pixels and Sobol fold table (the frame's only inputs),
    at a later bounce the radiance with the previous bounce's NEE added,
    are copied into the graph's static inputs (one copy shared by the
    bounces past the first), and the graph reads the previous bounce's
    outputs where they lie.  Outputs alternate between two sets of lane
    buffers by the bounce's parity, so the graphs hold two bounces' state
    whatever the depth.  The graphs share one memory pool and replay in
    the order they were captured.  ``clear`` drops them
    (``Renderer.update_scene`` clears), so a graph never reads a freed
    tensor.

    ``captures``, ``replays`` and ``eager_bounces`` (bounces run eagerly
    by a ``trace`` inside ``replaying`` the graphs) are host counters."""

    device_type = "cuda"  # the device ``_capture`` captures on

    def __init__(self):
        self.captures = self.replays = self.eager_bounces = 0
        self.clear()

    def clear(self):
        self._key = None
        self._bounces = []
        self._sets = [None, None]
        self._pool = self._stream = None

    def stats(self) -> dict[str, int]:
        return {"captures": self.captures, "replays": self.replays,
                "eager_bounces": self.eager_bounces}

    def engages(self, rays: Rays, stream: rng.SampleStream) -> bool:
        """Graphs replay a Sobol wavefront on a card with autograd off.
        RANDOM draws are keyed by host integers of the frame, which a graph
        would keep from its capture, and autograd needs the eager ops."""
        return (rays.o.device.type == self.device_type and stream.kind == 1
                and not torch.is_grad_enabled())

    def runner(self, scene: Scene, rays: Rays, stream: rng.SampleStream,
               cfg: IntegratorConfig):
        """The runner of a ``trace`` of ``rays``: these graphs where they
        engage and hold the wavefront's key, else an eager runner (which
        counts its bounces).  A new key drops the graphs and is held for
        the next wavefront."""
        if not self.engages(rays, stream):
            return _Eager(self)
        key = (rays.n, cfg, stream.seed, stream.scramble, stream.row0)
        if self._key is None or self._key[0] is not scene or self._key[1:] != key:
            self.clear()
            self._key = (scene, *key)
            return _Eager(self)
        return self

    def shade(self, i: int, fn, fresh):
        """Bounce ``i``: ``fresh`` copied into its graph's static inputs and
        the graph replayed (captured first, on the bounce's first use, with
        ``fn(*inputs)`` as its body); returns the graph's outputs, which
        the replay of bounce ``i + 2`` rewrites."""
        if i == len(self._bounces):
            self._bounces.append(self._capture_bounce(i, fn, fresh))
            self.captures += 1
        static, replay, out = self._bounces[i]
        for dst, src in zip(_tensors(static), _tensors(fresh), strict=True):
            dst.copy_(src)
        replay()
        self.replays += 1
        return out

    @staticmethod
    def handed(rays: Rays) -> Rays:
        """``rays`` for a query, with a fresh ``active`` mask: the live-ray
        tally and a caller's wrapper keep the mask past the frame, and a
        graph's output is rewritten by a later replay."""
        return rays.replace(active=rays.active.clone())

    def _capture_bounce(self, i: int, fn, fresh):
        """(static inputs, replay, outputs) of bounce ``i``'s graph."""
        static = self._bounces[1][0] if i > 1 else _map(fresh, torch.Tensor.clone)
        replay, out = self._capture(lambda: fn(*static), lambda o: self._keep(i % 2, o),
                                    _tensors(static)[0].device)
        return static, replay, out

    def _keep(self, parity: int, out):
        """``out`` with its tensors copied into output set ``parity`` (made
        from them on first use) and its other values its own."""
        kept = self._sets[parity]
        if kept is None:
            kept = self._sets[parity] = [t.clone() for t in _tensors(out)]
        else:
            for dst, src in zip(kept, _tensors(out), strict=True):
                dst.copy_(src)
        slots = iter(kept)
        return _map(out, lambda _: next(slots))

    def _capture(self, body, keep, device: torch.device):
        """(replay, outputs) of ``keep(body())`` captured as a CUDA graph on
        ``device``, after one eager ``body()`` on the capture stream, which
        keeps lazy initialisation out of the capture: ``torch.cuda.graph``'s
        steps, without its emptying of the allocator's caches before each
        capture, which made a 512x512 capture frame up to 0.8 s longer over
        its 8 captures."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            body()
            torch.cuda.synchronize(device)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._pool)
            try:
                out = keep(body())
            finally:
                graph.capture_end()
        return graph.replay, out
