"""The reference's bidirectional path tracer, written as pbrt-v3's BDPT
reads (``integrators/bdpt.cpp``): each lane walks a camera subpath and a
light subpath (``camera_subpath``, ``light_subpath``, both ``_walk``),
then every (s, t) strategy is evaluated on its own (``_s0``, ``_s1``,
``_connect``, ``_t1``), its contribution through the connection's G term,
and its balance-heuristic MIS weight from pbrt's ratio recursion over the
subpaths' vertices with the endpoints' reverse densities rewritten for it
(``mis_weight``).
Tensors run over lanes only; vertices and strategies are Python loops.

Sample layout.  Each lane draws from its pixel's Sobol stream at the
frame's sample index, in this order (D is ``max_depth``):

- dimensions 0 .. 3(D + 1) - 1: the camera walk, one 3D draw a step (the
  BSDF's lobe pick, then its direction), D + 1 steps, drawn at every step
  whether the path still lives or not;
- the next 5 + 3D: the light walk: the light pick (1), the point on the
  light (2), the emitted direction (2), then one 3D BSDF draw a step for
  D steps, again at every step;
- the next 3D: the s = 1 strategies in ascending t (t = 2 .. D + 1), each
  a light pick (1) and a point on the light (2).

The layout is part of what is compared: the program draws the same
dimensions for the same purposes, so a lane of the reference is the same
sample as the program's lane of that pixel and frame.

Departures from pbrt, each the semantics the program implements:

- pinhole camera: t = 0 never contributes, and (s = 1, t = 1) is not
  evaluated; the t = 1 strategies take s >= 2.  A strategy is kept where
  s + t - 2 <= D; the camera walk makes D + 1 scattering steps, the light
  walk D;
- a vertex's ``delta`` flag records how the vertex was reached (the scatter
  at the vertex before it was specular), where pbrt marks the scattering
  vertex itself; the ratio recursion reads the flag of a vertex and of the
  one before it, as pbrt does;
- a walk samples its BSDF at every vertex, the last one too, and rewrites
  the vertex before it's reverse density from that sample;
- no Russian roulette; the camera's subpath takes no ray differentials;
- the s = 0 strategy evaluates emission toward ``wo`` with the shading
  normal; G takes both shading normals; a vertex's area density takes the
  geometric normal's cosine;
- the s = 1 strategy resamples the light with ``sample_li`` (its
  solid-angle pdf times the uniform pick's) and needs the light on the
  geometric side of ``wo``; the resampled vertex's forward density in the
  MIS is ``pdf_le``'s position density times the pick's;
- directional lights start their subpaths on a disk of the scene's
  radius: the origin's forward density is 0 (remapped to 1), and the
  first surface vertex's forward density is the disk density projected
  onto it;
- zero densities count as 1 in the MIS ratios (``_remap0``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bsdf import uber
from ..bsdf.materials import fetch_bsdf
from ..bsdf.uber import UberBSDF
from ..config import IntegratorConfig
from ..core import math as m
from ..core.types import Rays
from ..lights import lights as lt
from ..sampling import rng
from ..scene.interaction import compute_interaction, spawn_ray, spawn_shadow_ray
from ..scene.scene import LIGHT_DIRECTIONAL, LIGHT_DISK, LIGHT_MESH, LIGHT_POINT, take_clip


@dataclass
class Vertex:
    """One vertex of a subpath, every field over the lanes (L, ...).  Index 0
    of a camera subpath is the camera, of a light subpath the point on the
    light; every later index is a surface vertex where ``valid``."""

    p: torch.Tensor  # (L, 3)
    ng: torch.Tensor  # (L, 3) geometric normal
    ns: torch.Tensor  # (L, 3) shading normal
    t: torch.Tensor  # (L, 3) shading tangent
    b: torch.Tensor  # (L, 3) shading bitangent
    wo: torch.Tensor  # (L, 3) toward the vertex before
    light: torch.Tensor  # (L,) area light at the vertex, -1 none
    beta: torch.Tensor  # (L, 3) throughput up to the vertex
    pdf_fwd: torch.Tensor  # (L,) area density of reaching it from the vertex before
    pdf_rev: torch.Tensor  # (L,) area density of reaching it from the vertex after
    delta: torch.Tensor  # (L,) bool: reached by a specular scatter
    on_surface: torch.Tensor  # (L,) bool: its densities take a cosine
    valid: torch.Tensor  # (L,) bool
    bsdf: UberBSDF | None = None  # surface vertices
    light_idx: torch.Tensor | None = None  # (L,) light id of a light origin, -1 unusable


def _remap0(x):
    return torch.where(x != 0.0, x, 1.0)


def _density(pdf_solid, from_p, to_p, to_ng, to_on_surface):
    """A solid-angle density at ``from_p`` as an area density at ``to_p``."""
    d = to_p - from_p
    d2 = torch.clamp_min(m.length_sq(d), 1e-12)
    w = d * torch.rsqrt(d2)[..., None]
    cos = torch.where(to_on_surface, torch.abs(m.dot(to_ng, w)), 1.0)
    return pdf_solid * cos / d2


def _local(v: Vertex, w):
    return m.to_local(v.t, v.b, v.ns, w)


def _f(v: Vertex, wi):
    """The BSDF at surface vertex ``v`` from its ``wo`` toward world ``wi``."""
    return uber.evaluate(v.bsdf, _local(v, v.wo), _local(v, wi))


def _pdf_area(v: Vertex, from_p, to: Vertex):
    """pbrt's ``Vertex::Pdf`` at surface vertex ``v``: the area density at
    ``to`` of sampling toward it, with ``wo`` toward ``from_p``."""
    wo = m.normalize(from_p - v.p)
    wi = m.normalize(to.p - v.p)
    return _density(uber.pdf(v.bsdf, _local(v, wo), _local(v, wi)), v.p, to.p, to.ng,
                    to.on_surface)


def _shading_correction(v: Vertex, wi):
    """Importance transport's shading-normal correction at ``v``."""
    num = torch.abs(m.dot(v.wo, v.ns)) * torch.abs(m.dot(wi, v.ng))
    den = torch.abs(m.dot(v.wo, v.ng)) * torch.abs(m.dot(wi, v.ns))
    return m.safe_div(num, den)


def is_delta_light(scene, l_idx):
    """Point and directional lights (pbrt's ``IsDeltaLight``); -1 is none."""
    ltype = take_clip(scene.lights.type, l_idx.clamp_min(0))
    return ((ltype == LIGHT_POINT) | (ltype == LIGHT_DIRECTIONAL)) & (l_idx >= 0)


def _walk(scene, rays: Rays, beta, pdf_dir, stream, path: list, steps: int,
          importance: bool, cfg: IntegratorConfig, intersect):
    """pbrt's ``RandomWalk``: append up to ``steps`` surface vertices to
    ``path``, which holds the origin.  Returns the stream."""
    active = rays.active
    reached_delta = torch.zeros_like(active)
    for _ in range(steps):
        prev = path[-1]
        hit = intersect(scene, rays)
        alive = active & hit.valid
        it = compute_interaction(scene, rays, hit)
        bsdf, it = fetch_bsdf(scene, it)
        zero = torch.zeros_like(pdf_dir)
        v = Vertex(p=it.p, ng=it.ng, ns=it.ns, t=it.dpdu, b=it.dpdv, wo=it.wo, light=it.light,
                   beta=torch.where(alive[:, None], beta, 0.0),
                   pdf_fwd=torch.where(alive, _density(pdf_dir, prev.p, it.p, it.ng,
                                                       torch.ones_like(alive)), 0.0),
                   pdf_rev=zero, delta=reached_delta, on_surface=alive, valid=alive, bsdf=bsdf)
        path.append(v)

        u, stream = rng.next_3d(stream)
        wo_l = _local(v, v.wo)
        bs = uber.sample(bsdf, wo_l, u)
        wi = m.to_world(v.t, v.b, v.ns, bs.wi)
        pdf_rev = torch.where(bs.is_specular, 0.0, uber.pdf(bsdf, bs.wi, wo_l))
        prev.pdf_rev = torch.where(alive, _density(pdf_rev, v.p, prev.p, prev.ng,
                                                   prev.on_surface), prev.pdf_rev)
        scale = bs.f * m.safe_div(torch.abs(m.dot(v.ns, wi)), bs.pdf)[..., None]
        if importance:
            scale = scale * _shading_correction(v, wi)[..., None]
        new_beta = beta * scale
        active = alive & bs.valid & ~m.is_black(new_beta)
        rays = spawn_ray(it, wi, cfg.trace_offset, cfg.max_trace_distance, active)
        pdf_dir = torch.where(bs.is_specular, 0.0, bs.pdf)
        beta = torch.where(active[:, None], new_beta, 0.0)
        reached_delta = torch.where(active, bs.is_specular, False)
    return stream


def camera_subpath(scene, camera, rays: Rays, stream, cfg: IntegratorConfig, intersect):
    """The camera vertex and up to D + 1 surface vertices (D + 2 in all)."""
    n, dev = rays.n, rays.o.device
    f = torch.zeros((n,), dtype=torch.bool, device=dev)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    fwd = camera.forward.expand(n, 3)
    origin = Vertex(p=camera.position.expand(n, 3), ng=fwd, ns=fwd, t=torch.zeros_like(fwd),
                    b=torch.zeros_like(fwd), wo=torch.zeros_like(fwd),
                    light=torch.full((n,), -1, dtype=torch.int32, device=dev),
                    beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
                    pdf_fwd=zero + 1.0, pdf_rev=zero, delta=f, on_surface=f, valid=~f)
    _, pdf_dir = camera.pdf_we(rays.d)
    path = [origin]
    stream = _walk(scene, rays, origin.beta, pdf_dir, stream, path, cfg.max_depth + 1, False,
                   cfg, intersect)
    return path, stream


def light_subpath(scene, stream, cfg: IntegratorConfig, intersect, n: int):
    """The point on a picked light and up to D surface vertices."""
    dev = stream.pixel.device
    u_pick, stream = rng.next_1d(stream)
    u_pos, stream = rng.next_2d(stream)
    u_dir, stream = rng.next_2d(stream)
    l_idx, pdf_pick = lt.pick_light(scene.lights, u_pick)
    le = lt.sample_le(scene, l_idx, u_pos, u_dir)
    ltype = take_clip(scene.lights.type, l_idx.clamp_min(0))
    usable = le.valid & (scene.lights.num > 0)
    infinite = ltype == LIGHT_DIRECTIONAL
    pdf_pos = le.pdf_pos * pdf_pick
    beta0 = le.le / torch.clamp_min(pdf_pos, 1e-20)[:, None]
    tl, bl = m.build_orthonormal_basis(le.n)
    origin = Vertex(p=le.p, ng=le.n, ns=le.n, t=tl, b=bl, wo=torch.zeros_like(le.n),
                    light=torch.full((n,), -1, dtype=torch.int32, device=dev),
                    beta=torch.where(usable[:, None], beta0, 0.0),
                    pdf_fwd=torch.where(usable & ~infinite, pdf_pos, 0.0),
                    pdf_rev=torch.zeros_like(pdf_pos), delta=torch.zeros_like(usable),
                    on_surface=((ltype == LIGHT_DISK) | (ltype == LIGHT_MESH)) & usable,
                    valid=usable, light_idx=torch.where(usable, l_idx, -1))
    cos0 = torch.where(ltype == LIGHT_POINT, 1.0, torch.abs(m.dot(le.n, le.d)))
    beta1 = beta0 * m.safe_div(cos0, le.pdf_dir)[:, None]
    offset = torch.where((ltype == LIGHT_POINT)[:, None], 0.0, cfg.trace_offset)
    rays = Rays(o=le.p + le.n * offset, d=le.d,
                tmin=torch.zeros((n,), dtype=torch.float32, device=dev),
                tmax=torch.full((n,), cfg.max_trace_distance, dtype=torch.float32, device=dev),
                active=usable)
    path = [origin]
    stream = _walk(scene, rays, beta1, le.pdf_dir, stream, path, cfg.max_depth, True, cfg,
                   intersect)
    if len(path) > 1:
        v1 = path[1]
        disk = le.pdf_pos * torch.abs(m.dot(le.d, v1.ng))
        v1.pdf_fwd = torch.where(infinite & v1.valid, disk, v1.pdf_fwd)
    return path, stream


def strategies(max_depth: int) -> list:
    """Every (s, t) evaluated, in pbrt's order (t, then s, ascending)."""
    return [(s, t) for t in range(1, max_depth + 3) for s in range(0, max_depth + 2)
            if s + t - 2 <= max_depth and (t >= 2 or s >= 2)]


def mis_weight(scene, cam: list | None, light: list, s: int, t: int, pt_rev, ptm_rev, qs_rev,
               qsm_rev, sampled: Vertex | None = None):
    """The balance-heuristic weight of strategy (s, t): pbrt's ``MISWeight``,
    the ratios of the other strategies' densities walked from the
    connection out along each subpath.  ``pt_rev`` .. ``qsm_rev`` are the
    rewritten reverse densities of the camera endpoint, the vertex before
    it, the light endpoint and the vertex before that; ``sampled`` is the
    s = 1 strategy's resampled light vertex."""
    if s + t == 2:
        return torch.ones_like(qs_rev)
    total = torch.zeros_like(qs_rev)
    ri = torch.ones_like(total)
    for i in range(t - 1, 0, -1):
        rev = pt_rev if i == t - 1 else ptm_rev if i == t - 2 else cam[i].pdf_rev
        ri = ri * _remap0(rev) / _remap0(cam[i].pdf_fwd)
        delta = cam[i - 1].delta if i == t - 1 else cam[i].delta | cam[i - 1].delta
        total = total + torch.where(~delta & cam[i].valid, ri, 0.0)
    ri = torch.ones_like(total)
    for i in range(s - 1, -1, -1):
        q = sampled if s == 1 else light[i]
        rev = qs_rev if i == s - 1 else qsm_rev if i == s - 2 else q.pdf_rev
        ri = ri * _remap0(rev) / _remap0(q.pdf_fwd)
        before = is_delta_light(scene, q.light_idx) if i == 0 else light[i - 1].delta
        delta = before if i == s - 1 else q.delta | before
        total = total + torch.where(~delta & q.valid, ri, 0.0)
    return 1.0 / (1.0 + total)


@dataclass
class Connection:
    """One strategy's weighted contribution on every lane, ``ok`` where it
    can contribute, the shadow ray that decides it (None for s = 0), and
    for t = 1 the row-major pixel it splats onto."""

    contrib: torch.Tensor  # (L, 3)
    ok: torch.Tensor  # (L,) bool
    shadow: Rays | None
    pixel: torch.Tensor | None = None  # (L,) long


def _s0(scene, cam, light, t):
    pt, ptm = cam[t - 1], cam[t - 2]
    lid = pt.light.clamp_min(0)
    emitter = pt.light >= 0
    contrib = pt.beta * lt.eval_le(scene, pt.light, pt.ns, pt.wo)
    pdf_pos, _ = lt.pdf_le(scene, lid, pt.ns, pt.ns)
    pt_rev = torch.where(emitter, pdf_pos / float(max(scene.lights.num, 1)), 0.0)
    _, pdf_dir = lt.pdf_le(scene, lid, pt.ns, m.normalize(ptm.p - pt.p))
    ptm_rev = _density(torch.where(emitter, pdf_dir, 0.0), pt.p, ptm.p, ptm.ng, ptm.on_surface)
    zero = torch.zeros_like(pt_rev)
    w = mis_weight(scene, cam, light, 0, t, pt_rev, ptm_rev, zero, zero)
    return Connection(contrib * w[..., None], pt.valid & emitter, None)


def _s1(scene, cam, light, t, u_pick, u_light, cfg, weighted=True):
    pt, ptm = cam[t - 1], cam[t - 2]
    l_idx, pdf_pick = lt.pick_light(scene.lights, u_pick)
    ls = lt.sample_li(scene, l_idx, pt.p, u_light)
    f = _f(pt, ls.wi)
    ok = pt.valid & ls.valid & ~m.is_black(f) & (scene.lights.num > 0)
    ok = ok & (m.dot(pt.ng, ls.wi) * m.dot(pt.ng, pt.wo) > 0.0)
    contrib = (pt.beta * f * ls.li
               * m.safe_div(torch.abs(m.dot(pt.ns, ls.wi)), ls.pdf * pdf_pick)[..., None])
    shadow = spawn_shadow_ray(pt, ls.wi, ls.dist, cfg.trace_offset, ok)
    if not weighted:
        return Connection(contrib, ok, shadow)
    # the resampled light vertex is the strategy's one-vertex light subpath;
    # the MIS reads its position, normal, densities and flags
    pdf_pos, _ = lt.pdf_le(scene, l_idx, ls.n, ls.wi)
    on = torch.ones_like(ok)
    blank = torch.zeros_like(ls.p)
    q = Vertex(p=ls.p, ng=ls.n, ns=ls.n, t=blank, b=blank, wo=blank, light=l_idx, beta=blank,
               pdf_fwd=pdf_pos * pdf_pick, pdf_rev=torch.zeros_like(pdf_pos),
               delta=ls.is_delta, on_surface=on, valid=ok, light_idx=l_idx)
    # pt's reverse density: the light emitting toward pt (directional
    # lights: the disk density projected onto pt)
    lid = torch.where(ok, l_idx, -1)
    w_out = m.normalize(pt.p - ls.p)
    pos, pdf_dir = lt.pdf_le(scene, lid.clamp_min(0), ls.n, w_out)
    infinite = (take_clip(scene.lights.type, lid.clamp_min(0)) == LIGHT_DIRECTIONAL) & (lid >= 0)
    pt_rev = torch.where(infinite, pos * torch.abs(m.dot(pt.ng, w_out)),
                         _density(pdf_dir, ls.p, pt.p, pt.ng, on))
    ptm_rev = _pdf_area(pt, ls.p, ptm)
    qs_rev = _pdf_area(pt, ptm.p, q)
    w = mis_weight(scene, cam, light, 1, t, pt_rev, ptm_rev, qs_rev, torch.zeros_like(qs_rev),
                   sampled=q)
    return Connection(contrib * w[..., None], ok, shadow)


def _connect(scene, cam, light, s, t, cfg):
    pt, ptm, qs, qsm = cam[t - 1], cam[t - 2], light[s - 1], light[s - 2]
    d = qs.p - pt.p
    d2 = torch.clamp_min(m.length_sq(d), 1e-12)
    dist = torch.sqrt(d2)
    w = d / dist[..., None]
    f_pt = _f(pt, w)
    f_qs = _f(qs, -w) * _shading_correction(qs, -w)[..., None]
    g = torch.abs(m.dot(pt.ns, w)) * torch.abs(m.dot(qs.ns, w)) / d2
    contrib = pt.beta * f_pt * g[..., None] * f_qs * qs.beta
    ok = pt.valid & qs.valid & ~m.is_black(contrib)
    shadow = spawn_shadow_ray(pt, w, dist, cfg.trace_offset, ok)
    wgt = mis_weight(scene, cam, light, s, t, _pdf_area(qs, qsm.p, pt), _pdf_area(pt, qs.p, ptm),
                     _pdf_area(pt, ptm.p, qs), _pdf_area(qs, pt.p, qsm))
    return Connection(contrib * wgt[..., None], ok, shadow)


def _t1(scene, camera, light, s, cfg, width: int, height: int, keep=None):
    """The light subpath's vertex s - 1 seen by the camera; only where
    ``keep`` (a (W*H,) bool table) holds the pixel it lands on does it get a
    shadow ray."""
    qs, qsm = light[s - 1], light[s - 2]
    wi, dist, we, pdf, uv, inside = camera.sample_wi(qs.p)
    f = _f(qs, wi) * _shading_correction(qs, wi)[..., None]
    ok = qs.valid & inside & (we > 0.0) & ~m.is_black(f)
    contrib = qs.beta * f * (we * m.safe_div(torch.abs(m.dot(qs.ns, wi)), pdf))[..., None]
    # the film's raster: row-major, v = 0 the bottom row
    px = (uv[..., 0] * width).to(torch.int32).clamp(0, width - 1)
    py = (uv[..., 1] * height).to(torch.int32).clamp(0, height - 1)
    pixel = (py * width + px).long()
    if keep is not None:
        ok = ok & keep[pixel]
    shadow = spawn_shadow_ray(qs, wi, dist, cfg.trace_offset, ok)
    eye = camera.position.expand_as(qs.p)
    _, pdf_dir = camera.pdf_we(m.normalize(qs.p - eye))
    qs_rev = _density(pdf_dir, eye, qs.p, qs.ng, torch.ones_like(ok))
    zero = torch.zeros_like(qs_rev)
    wgt = mis_weight(scene, None, light, s, 1, zero, zero, qs_rev, _pdf_area(qs, eye, qsm))
    return Connection(contrib * wgt[..., None], ok, shadow, pixel)


def _visible(scene, occluded, conns: list) -> list:
    """Each connection's ``ok`` and unblocked, from one occlusion query over
    every shadow ray of the list."""
    rays = [c.shadow for c in conns]
    table = Rays(**{k: torch.cat([getattr(r, k) for r in rays]) for k in
                    ("o", "d", "tmin", "tmax", "active")})
    blocked = occluded(scene, table).split([r.n for r in rays])
    return [c.ok & ~b for c, b in zip(conns, blocked)]


def own_radiance(scene, camera, rays: Rays, stream, cfg: IntegratorConfig, intersect,
                 occluded, s1_only: bool = False) -> torch.Tensor:
    """(L, 3): every strategy of each lane but the t = 1 splats, which land
    on other pixels (``splats``).  ``s1_only`` keeps the s = 1 strategies,
    unweighted: the path tracer's next-event estimate over the same
    camera subpath."""
    cam, stream = camera_subpath(scene, camera, rays, stream, cfg, intersect)
    light, stream = light_subpath(scene, stream, cfg, intersect, rays.n)
    radiance = torch.zeros_like(rays.o)
    shadowed = []
    for s, t in strategies(cfg.max_depth):
        if t == 1 or (s1_only and s != 1):
            continue
        if s == 0:
            c = _s0(scene, cam, light, t)
            radiance = radiance + torch.where(c.ok[..., None], c.contrib, 0.0)
        elif s == 1:
            u_pick, stream = rng.next_1d(stream)
            u_light, stream = rng.next_2d(stream)
            shadowed.append(_s1(scene, cam, light, t, u_pick, u_light, cfg, not s1_only))
        else:
            shadowed.append(_connect(scene, cam, light, s, t, cfg))
    if shadowed:
        for c, vis in zip(shadowed, _visible(scene, occluded, shadowed)):
            radiance = radiance + torch.where(vis[..., None], c.contrib, 0.0)
    return radiance


def splats(scene, camera, stream, cfg: IntegratorConfig, intersect, occluded, n: int,
           width: int, height: int, keep) -> list:
    """The t = 1 strategies of ``n`` lanes whose streams stand at the light
    walk (``skip_camera_walk``): one (row-major pixel, visible, weighted
    contribution) a strategy, each (L, ...).  Only the splats onto pixels
    where ``keep`` (a (W*H,) bool table) holds are traced and can be
    visible."""
    light, _ = light_subpath(scene, stream, cfg, intersect, n)
    conns = [_t1(scene, camera, light, s, cfg, width, height, keep)
             for s, t in strategies(cfg.max_depth) if t == 1]
    if not conns:
        return []
    return [(c.pixel, vis, c.contrib) for c, vis in zip(conns, _visible(scene, occluded, conns))]


def skip_camera_walk(stream, cfg: IntegratorConfig):
    """The stream past the camera walk's draws: where the light walk starts."""
    return stream.advance(3 * (cfg.max_depth + 1))

