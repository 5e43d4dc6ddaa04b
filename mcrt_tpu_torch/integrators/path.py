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
"""
from __future__ import annotations

from typing import Callable

import torch

from ..bsdf import uber
from ..bsdf.materials import fetch_bsdf
from ..config import IntegratorConfig
from ..core import math as m
from ..core.types import Rays, Throughput
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
    bounce, as in the JAX package."""
    n = rays.n
    tp = Throughput.fresh(n, rays.o.device)
    prev_pdf = torch.ones((n,), dtype=torch.float32, device=rays.o.device)
    prev_p = rays.o
    for i in range(cfg.max_depth):
        hit = intersect(scene, rays)
        with span("mcrt.shade"):
            (rays, tp, stream, prev_pdf, prev_p, srays, contrib, nee_ok) = _shade(
                scene, cfg, i, rays, hit, tp, stream, prev_pdf, prev_p,
                diff if i == 0 else None)
        vis = nee_ok & ~occluded(scene, srays) if cfg.enable_shadows else nee_ok
        tp = tp.replace(radiance=tp.radiance + torch.where(vis[..., None], contrib, 0.0))
    return tp.radiance
