"""Bidirectional path tracer (counterpart of ``mcrt_tpu/integrators/bdpt.py``).

One BDPT sample per pixel: a camera subpath of up to ``max_depth + 2``
vertices, a light subpath of up to ``max_depth + 1`` vertices (directional
lights start on a disk of the scene's radius), then every (s, t) connection
strategy, batched by family over a leading strategy axis as (S, N, ...)
tensors:

- ``s=0``: the camera subpath hit a light; no visibility ray;
- ``s=1``: a light resampled at each camera vertex (NEE inside BDPT);
- ``s>=2, t>=2``: connections through the geometric term;
- ``t=1``: light vertices connected to the camera and splatted onto the
  film with ``index_add_``.

The strategy tables are static Python lists, so every gather of endpoint
vertices is a static slice and the balance-heuristic MIS weights come from
one masked ratio walk over the vertex axis shared by a family's strategies.
The shadow rays of all families are staged, then resolved by occlusion
queries of at most ``OCC_CHUNK_RAYS`` rays each.

A walk builds each vertex as its own (N, ...) record, replaced out of
place as later steps fill its fields in, and stacks the records into
(N, V, ...) tensors once the subpath is done; each vertex's BSDF
parameters are fetched once, during the walk, and reused by every
strategy.  Nothing is written in place, so the estimate is differentiable
under autograd with respect to the scene's tensors, as the JAX package's
is under ``jax.grad``: the BSDF-sampled directions and pdfs are detached
(``uber.sample``) and the queries return no graph, as there.  Nothing here
reads a device value on the host: every mask is a ``torch.where``.  The
t=1 splats are float atomics on the card (``index_add``, whose backward is
a gather of the film's cotangent at the splat slots), so a frame's bits
there can differ from run to run.

Pinhole camera only (t=0 never contributes), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass

import torch

from ..bsdf import uber
from ..bsdf.materials import fetch_bsdf
from ..bsdf.uber import UberBSDF
from ..camera.pinhole import PinholeCamera
from ..config import IntegratorConfig
from ..core import math as m
from ..core.types import Interaction, Rays, TensorRecord, device_constant
from ..lights import lights as lt
from ..sampling import rng
from ..scene.interaction import compute_interaction, spawn_ray, spawn_shadow_ray
from ..scene.scene import (LIGHT_DIRECTIONAL, LIGHT_DISK, LIGHT_MESH, LIGHT_POINT,
                           Scene, take_clip)

VT_CAMERA = 0
VT_LIGHT = 1
VT_SURFACE = 2

# most rays of one batched occlusion query: the blocked accel's per-query
# tables grow with the ray count, so the staged shadow rays go in chunks
OCC_CHUNK_RAYS = int(os.environ.get("MCRT_BDPT_OCC_RAYS", str(1 << 21)))


def _vertex_slice(a: torch.Tensor, idxs: list[int]) -> torch.Tensor:
    """(N, V, ...) -> (S, N, ...) at the static vertex indices ``idxs``: a
    view where they are consecutive, else a stacked copy."""
    lo = idxs[0]
    if list(idxs) == list(range(lo, lo + len(idxs))):
        return a[:, lo:lo + len(idxs)].movedim(1, 0)
    return torch.stack([a[:, i] for i in idxs], dim=0)


@dataclass
class _VertexFields(TensorRecord):
    """A path vertex's fields; the leading dims are ``Vertex``'s (N,) or
    ``Vertices``' (N, V), then the shapes below."""

    vtype: torch.Tensor  # i32
    p: torch.Tensor  # (3,)
    ng: torch.Tensor  # (3,)
    ns: torch.Tensor  # (3,)
    t: torch.Tensor  # (3,) shading tangent
    b: torch.Tensor  # (3,) shading bitangent
    uv: torch.Tensor  # (2,)
    wo: torch.Tensor  # (3,) toward the previous vertex
    material: torch.Tensor  # i32 (-1 none)
    light: torch.Tensor  # i32 area light at the vertex (-1)
    light_idx: torch.Tensor  # i32 light table id of a VT_LIGHT vertex
    beta: torch.Tensor  # (3,) throughput up to the vertex
    pdf_fwd: torch.Tensor  # area density from the previous vertex
    pdf_rev: torch.Tensor  # area density from the next vertex
    delta: torch.Tensor  # bool: reached by delta sampling
    on_surface: torch.Tensor  # bool: area conversions take a cosine
    valid: torch.Tensor  # bool


class Vertex(_VertexFields):
    """One path vertex of every lane, leading dim (N,): a walk's record of
    the vertex while its fields are filled in."""

    @classmethod
    def empty(cls, n: int, device) -> "Vertex":
        def z(*shape, dtype=torch.float32):
            return torch.zeros((n,) + shape, dtype=dtype, device=device)

        def neg():
            return torch.full((n,), -1, dtype=torch.int32, device=device)

        return cls(vtype=z(dtype=torch.int32), p=z(3), ng=z(3), ns=z(3), t=z(3), b=z(3),
                   uv=z(2), wo=z(3), material=neg(), light=neg(), light_idx=neg(),
                   beta=z(3), pdf_fwd=z(), pdf_rev=z(), delta=z(dtype=torch.bool),
                   on_surface=z(dtype=torch.bool), valid=z(dtype=torch.bool))

    def set(self, **fields) -> "Vertex":
        """A copy with ``fields`` replaced, each value (a tensor or a Python
        scalar) broadcast to its field's shape and dtype; the other fields
        are shared."""
        def fit(old, v):
            if isinstance(v, torch.Tensor):
                return v.to(old.dtype).expand(old.shape)
            return torch.full(old.shape, v, dtype=old.dtype, device=old.device)

        return dataclasses.replace(self, **{k: fit(getattr(self, k), v)
                                            for k, v in fields.items()})


class Vertices(_VertexFields):
    """A finished subpath: the fields of its ``Vertex`` records stacked to
    leading dims (N, V)."""

    @classmethod
    def stack(cls, verts: list[Vertex]) -> "Vertices":
        return cls(**{f.name: torch.stack([getattr(v, f.name) for v in verts], dim=1)
                      for f in dataclasses.fields(_VertexFields)})

    def at(self, i: int) -> Vertex:
        """Vertex ``i`` of every lane."""
        return Vertex(**{f.name: getattr(self, f.name)[:, i]
                         for f in dataclasses.fields(self)})

    def gather(self, idxs: list[int]) -> "Vertices":
        """The vertices at static indices ``idxs`` stacked to (S, N, ...)."""
        return Vertices(**{f.name: _vertex_slice(getattr(self, f.name), idxs)
                           for f in dataclasses.fields(self)})


def _gather_bsdfs(bsdfs: list[UberBSDF], idxs: list[int]) -> UberBSDF:
    """The per-vertex BSDFs at static indices ``idxs`` stacked to
    (S, N, ...); the static ``dist`` and ``used`` fields pass through."""
    first = bsdfs[idxs[0]]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(bsdfs[i], f.name) for i in idxs], dim=0)
        for f in dataclasses.fields(first) if isinstance(getattr(first, f.name), torch.Tensor)})


def _convert_density(pdf_solid, from_p, to_p, to_ng, to_on_surface):
    """Solid-angle -> area density."""
    d = to_p - from_p
    d2 = torch.clamp_min(m.length_sq(d), 1e-12)
    w = d * torch.rsqrt(d2)[..., None]
    cos = torch.abs(m.dot(to_ng, w))
    factor = torch.where(to_on_surface, cos, 1.0)
    return pdf_solid * factor / d2


def _remap0(x):
    """0 pdfs count as 1 in the MIS ratios (delta handling)."""
    return torch.where(x != 0.0, x, 1.0)


def _g_term(a_p, a_ns, b_p, b_ns):
    d = b_p - a_p
    d2 = torch.clamp_min(m.length_sq(d), 1e-12)
    w = d * torch.rsqrt(d2)[..., None]
    return torch.abs(m.dot(a_ns, w)) * torch.abs(m.dot(b_ns, w)) / d2


def _zero_bsdf(n: int, device, like: UberBSDF | None = None) -> UberBSDF:
    """Lobe-less BSDF of an origin vertex (never evaluated); the static
    fields copy ``like``'s so every vertex's record has the same form."""
    def z(*shape):
        return torch.zeros((n,) + shape, dtype=torch.float32, device=device)

    return UberBSDF(diffuse=z(3), glossy=z(3), kr=z(3), kt=z(3), passthrough=z(3),
                    alpha=z(), eta=z(), conductor_eta=z(3), conductor_k=z(3),
                    rs_blend=z(3),
                    dist=like.dist if like is not None else 0,
                    used=like.used if like is not None else (True,) * 7)


def random_walk(scene: Scene, rays: Rays, beta: torch.Tensor, pdf_dir: torch.Tensor,
                stream: rng.SampleStream, verts: list[Vertex], start_index: int,
                n_steps: int, importance_mode: bool, cfg: IntegratorConfig, intersect):
    """Extend a subpath by up to ``n_steps`` surface vertices, each a new
    record in the list ``verts``.  Returns (verts, stream, per-vertex
    BSDFs): a list of V records, the origin's lobe-less."""
    active = rays.active
    n, n_verts = rays.n, len(verts)
    step_bsdfs: dict[int, UberBSDF] = {}

    for step in range(n_steps):
        i = start_index + step
        hit = intersect(scene, rays)
        alive = active & hit.valid
        it = compute_interaction(scene, rays, hit)
        bsdf, it = fetch_bsdf(scene, it)
        step_bsdfs[i] = bsdf

        pv = verts[i - 1]
        pdf_fwd = _convert_density(pdf_dir, pv.p, it.p, it.ng, torch.ones_like(hit.valid))
        verts[i] = verts[i].set(
            vtype=VT_SURFACE, p=it.p, ng=it.ng, ns=it.ns, t=it.dpdu, b=it.dpdv,
            uv=it.uv, wo=it.wo, material=it.material, light=it.light,
            beta=torch.where(alive[:, None], beta, 0.0),
            pdf_fwd=torch.where(alive, pdf_fwd, 0.0), on_surface=alive, valid=alive)

        u_bsdf, stream = rng.next_3d(stream)
        wo_l = m.to_local(it.dpdu, it.dpdv, it.ns, it.wo)
        bs = uber.sample(bsdf, wo_l, u_bsdf)
        wi_w = m.to_world(it.dpdu, it.dpdv, it.ns, bs.wi)

        # reverse pdf of the previous vertex (wi and wo swapped)
        pdf_rev_solid = torch.where(bs.is_specular, 0.0, uber.pdf(bsdf, bs.wi, wo_l))
        prev_rev = _convert_density(pdf_rev_solid, it.p, pv.p, pv.ng, pv.on_surface)
        verts[i - 1] = pv.set(pdf_rev=torch.where(alive, prev_rev, pv.pdf_rev))

        cos_wi = torch.abs(m.dot(it.ns, wi_w))
        w_mul = bs.f * m.safe_div(cos_wi, bs.pdf)[..., None]
        if importance_mode:
            # shading-normal correction of importance transport
            num = torch.abs(m.dot(it.wo, it.ns)) * torch.abs(m.dot(wi_w, it.ng))
            den = torch.abs(m.dot(it.wo, it.ng)) * torch.abs(m.dot(wi_w, it.ns))
            w_mul = w_mul * m.safe_div(num, den)[..., None]
        new_beta = beta * w_mul
        extend = alive & bs.valid & ~m.is_black(new_beta)
        rays = spawn_ray(it, wi_w, cfg.trace_offset, cfg.max_trace_distance, extend)
        pdf_dir = torch.where(bs.is_specular, 0.0, bs.pdf)
        beta = torch.where(extend[:, None], new_beta, 0.0)
        active = extend
        # a vertex's delta flag records how it was reached: mark vertex i+1
        if i + 1 < n_verts:
            verts[i + 1] = verts[i + 1].set(delta=torch.where(extend, bs.is_specular, False))

    zero = _zero_bsdf(n, rays.o.device, step_bsdfs.get(start_index))
    return verts, stream, [step_bsdfs.get(i, zero) for i in range(n_verts)]


def generate_camera_subpath(scene, camera, rays, stream, n_verts, cfg, intersect):
    n = rays.n
    verts = [Vertex.empty(n, rays.o.device)] * n_verts
    _, pdf_dir = camera.pdf_we(rays.d)
    verts[0] = verts[0].set(vtype=VT_CAMERA, p=camera.position, ng=camera.forward,
                            ns=camera.forward, beta=1.0, pdf_fwd=1.0, valid=True)
    beta = torch.ones((n, 3), dtype=torch.float32, device=rays.o.device)
    verts, stream, bsdfs = random_walk(scene, rays, beta, pdf_dir, stream, verts, 1,
                                       n_verts - 1, importance_mode=False, cfg=cfg,
                                       intersect=intersect)
    return Vertices.stack(verts), stream, bsdfs


def generate_light_subpath(scene, stream, n_verts, cfg, intersect, n):
    device = stream.pixel.device
    verts = [Vertex.empty(n, device)] * n_verts
    u_pick, stream = rng.next_1d(stream)
    u_pos, stream = rng.next_2d(stream)
    u_dir, stream = rng.next_2d(stream)
    l_idx, pdf_choice = lt.pick_light(scene.lights, u_pick)
    le = lt.sample_le(scene, l_idx, u_pos, u_dir)
    ltype = take_clip(scene.lights.type, l_idx.clamp_min(0))
    usable = le.valid & (scene.lights.num > 0)

    pdf_origin = le.pdf_pos * pdf_choice
    beta0 = le.le / torch.clamp_min(pdf_origin, 1e-20)[:, None]
    tl, bl = m.build_orthonormal_basis(le.n)
    is_inf = ltype == LIGHT_DIRECTIONAL
    verts[0] = verts[0].set(
        vtype=VT_LIGHT, p=le.p, ng=le.n, ns=le.n, t=tl, b=bl,
        light_idx=torch.where(usable, l_idx, -1),
        beta=torch.where(usable[:, None], beta0, 0.0),
        # a directional light's origin density is that of re-sampling its
        # (delta) direction: 0, which remap0 turns into 1 in the MIS ratios
        pdf_fwd=torch.where(usable & ~is_inf, pdf_origin, 0.0),
        # the delta field records how a vertex was reached: never for an
        # origin; whether the light itself is delta comes from its type
        delta=False, valid=usable,
        on_surface=((ltype == LIGHT_DISK) | (ltype == LIGHT_MESH)) & usable)
    cos0 = torch.where(ltype == LIGHT_POINT, 1.0, torch.abs(m.dot(le.n, le.d)))
    beta1 = beta0 * m.safe_div(cos0, le.pdf_dir)[:, None]
    offset = torch.where((ltype == LIGHT_POINT)[:, None], 0.0, cfg.trace_offset)
    rays = Rays(o=le.p + le.n * offset, d=le.d,
                tmin=torch.zeros((n,), dtype=torch.float32, device=device),
                tmax=torch.full((n,), cfg.max_trace_distance, dtype=torch.float32,
                                device=device),
                active=usable)
    verts, stream, bsdfs = random_walk(scene, rays, beta1, le.pdf_dir, stream, verts, 1,
                                       n_verts - 1, importance_mode=True, cfg=cfg,
                                       intersect=intersect)
    # directional lights: the first surface vertex's forward density is the
    # disk density 1/(pi r^2) projected onto the surface, not a solid-angle
    # conversion of the delta direction's pdf
    if n_verts > 1:
        v1 = verts[1]
        pdf1_inf = le.pdf_pos * torch.abs(m.dot(le.d, v1.ng))
        verts[1] = v1.set(pdf_fwd=torch.where(is_inf & v1.valid, pdf1_inf, v1.pdf_fwd))
    return Vertices.stack(verts), stream, bsdfs


# --------------------------------------------------------------------------
# Batched MIS ratio walk
# --------------------------------------------------------------------------


def _column(values, device) -> torch.Tensor:
    """(S, 1) float32 column of a static per-strategy table (a cached
    device constant; small integers compare exactly in float32)."""
    return device_constant(tuple(float(v) for v in values), device)[:, None]


def _mis_weights(s_arr, t_arr, cam: Vertices, light: Vertices,
                 pt_rev, pt_minus_rev, qs_rev, qs_minus_rev,
                 light0_fwd, light0_rev, light0_delta, light0_valid, light0_is_delta):
    """Balance-heuristic MIS weights of a batch of strategies, (S, N).

    ``s_arr``/``t_arr``: each strategy's static (s, t).  The four ``*_rev``
    arguments are the endpoint densities that the strategy rewrites, (S, N);
    ``light0_*`` are the light path's index-0 fields per strategy (the
    walked light origin for s >= 2, the resampled light vertex for s = 1)."""
    S, device = len(s_arr), cam.p.device
    n, v_t, v_s = cam.p.shape[0], cam.p.shape[1], light.p.shape[1]
    s_col, t_col = _column(s_arr, device), _column(t_arr, device)
    f_ = torch.zeros((1, n), dtype=torch.bool, device=device)
    sum_ri = torch.zeros((S, n), dtype=torch.float32, device=device)

    # camera side: i = t-1 .. 1 (connection endpoints are never delta)
    ri = torch.ones((S, n), dtype=torch.float32, device=device)
    for j in range(v_t - 1, 0, -1):
        in_path = j <= t_col - 1
        rev = torch.where(j == t_col - 1, pt_rev,
                          torch.where(j == t_col - 2, pt_minus_rev, cam.pdf_rev[None, :, j]))
        r = _remap0(rev) / _remap0(cam.pdf_fwd[None, :, j])
        ri = torch.where(in_path, ri * r, ri)
        d_j = torch.where(j == t_col - 1, f_, cam.delta[None, :, j])
        use = in_path & ~(d_j | cam.delta[None, :, j - 1]) & cam.valid[None, :, j]
        sum_ri = sum_ri + torch.where(use, ri, 0.0)

    # light side: i = s-1 .. 0; no strategy connects to the origin of a
    # delta light (point or directional), read from the light's type
    ri = torch.ones((S, n), dtype=torch.float32, device=device)
    for j in range(v_s - 1, -1, -1):
        in_path = j <= s_col - 1
        stored_rev = light.pdf_rev[None, :, j] if j > 0 else light0_rev
        rev = torch.where(j == s_col - 1, qs_rev,
                          torch.where(j == s_col - 2, qs_minus_rev, stored_rev))
        fwd = light.pdf_fwd[None, :, j] if j > 0 else light0_fwd
        r = _remap0(rev) / _remap0(fwd)
        ri = torch.where(in_path, ri * r, ri)
        d_j = torch.where(j == s_col - 1, f_,
                          light.delta[None, :, j] if j > 0 else light0_delta)
        d_prev = (light0_is_delta if j == 0
                  else (light.delta[None, :, j - 1] if j > 1 else light0_delta))
        valid_j = light.valid[None, :, j] if j > 0 else light0_valid
        use = in_path & ~(d_j | d_prev) & valid_j
        sum_ri = sum_ri + torch.where(use, ri, 0.0)

    w = 1.0 / (1.0 + sum_ri)
    return torch.where(s_col + t_col == 2.0, 1.0, w)


def _is_delta_light(scene: Scene, l_idx: torch.Tensor) -> torch.Tensor:
    ltype = take_clip(scene.lights.type, l_idx.clamp_min(0))
    return ((ltype == LIGHT_POINT) | (ltype == LIGHT_DIRECTIONAL)) & (l_idx >= 0)


def _light0_fields(scene, light: Vertices, S: int):
    """The walked light origin's index-0 fields, broadcast over S."""
    def b(a):
        return a[None, :].expand((S,) + a.shape)

    return (b(light.pdf_fwd[:, 0]), b(light.pdf_rev[:, 0]), b(light.delta[:, 0]),
            b(light.valid[:, 0]), b(_is_delta_light(scene, light.light_idx[:, 0])))


def _pdf_vertex(bsdf: UberBSDF, v, new_wo_p, next_p, next_ng, next_surf):
    """Area pdf of a surface vertex generating ``next`` with wo replaced by
    dir(v -> new_wo_p); all inputs (S, N, ...)."""
    wo = m.normalize(new_wo_p - v.p)
    wi = m.normalize(next_p - v.p)
    pdf_solid = uber.pdf(bsdf, m.to_local(v.t, v.b, v.ns, wo), m.to_local(v.t, v.b, v.ns, wi))
    return _convert_density(pdf_solid, v.p, next_p, next_ng, next_surf)


def _pdf_light_dir_v(scene, light_idx, light_p, light_ns, next_p, next_ng, next_surf):
    """Area pdf of a light vertex emitting toward ``next``; directional
    lights use the disk density 1/(pi r^2) projected onto the receiver."""
    w = m.normalize(next_p - light_p)
    pdf_pos, pdf_dir = lt.pdf_le(scene, light_idx.clamp_min(0), light_ns, w)
    ltype = take_clip(scene.lights.type, light_idx.clamp_min(0))
    is_inf = (ltype == LIGHT_DIRECTIONAL) & (light_idx >= 0)
    pdf_area = _convert_density(pdf_dir, light_p, next_p, next_ng, next_surf)
    cos_next = torch.where(next_surf, torch.abs(m.dot(next_ng, w)), 1.0)
    return torch.where(is_inf, pdf_pos * cos_next, pdf_area)


def _eval_f(bsdf: UberBSDF, v, wi_world):
    """BSDF value at vertices ``v`` toward world direction wi (wo stored)."""
    return uber.evaluate(bsdf, m.to_local(v.t, v.b, v.ns, v.wo),
                         m.to_local(v.t, v.b, v.ns, wi_world))


def _shading_normal_correction(v, wi):
    """Importance transport's shading-normal correction at a light-subpath
    vertex."""
    num = torch.abs(m.dot(v.wo, v.ns)) * torch.abs(m.dot(wi, v.ng))
    den = torch.abs(m.dot(v.wo, v.ng)) * torch.abs(m.dot(wi, v.ns))
    return m.safe_div(num, den)


def _interaction_of(v) -> Interaction:
    return Interaction(p=v.p, ng=v.ng, ns=v.ns, dpdu=v.t, dpdv=v.b, uv=v.uv, wo=v.wo,
                       duvdx=None, duvdy=None, material=v.material, light=v.light,
                       valid=v.valid)


# --------------------------------------------------------------------------
# Strategy families (each evaluates all its (s, t) pairs as one batch)
# --------------------------------------------------------------------------


def _family_s0(scene, camera, cam, light, cam_bsdfs, pairs):
    """The camera subpath hit a light: no visibility ray; returns the summed
    weighted contribution (N, 3)."""
    t_arr = [t for (_, t) in pairs]
    pt = cam.gather([t - 1 for t in t_arr])  # (S, N, ...)
    ptm = cam.gather([t - 2 for t in t_arr])
    S, n = len(pairs), cam.p.shape[0]

    is_light = pt.valid & (pt.light >= 0)
    contrib = pt.beta * lt.eval_le(scene, pt.light, pt.ns, pt.wo)

    # pt is a light: the origin's density and the emission direction's
    num_l = float(max(scene.lights.num, 1))
    pdf_pos0, _ = lt.pdf_le(scene, pt.light.clamp_min(0), pt.ns, pt.ns)
    pt_rev = torch.where(pt.light >= 0, pdf_pos0 / num_l, 0.0)
    w_dir = m.normalize(ptm.p - pt.p)
    _, pdf_dir = lt.pdf_le(scene, pt.light.clamp_min(0), pt.ns, w_dir)
    pdf_dir = torch.where(pt.light >= 0, pdf_dir, 0.0)
    pt_minus_rev = _convert_density(pdf_dir, pt.p, ptm.p, ptm.ng, ptm.on_surface)

    zero = torch.zeros((S, n), dtype=torch.float32, device=cam.p.device)
    fls = torch.zeros((S, n), dtype=torch.bool, device=cam.p.device)
    w = _mis_weights([0] * S, t_arr, cam, light, pt_rev, pt_minus_rev, zero, zero,
                     zero, zero, fls, fls, fls)
    out = torch.where(is_light[..., None], contrib * w[..., None], 0.0)
    return torch.sum(out, dim=0)


def _family_s1(scene, camera, cam, light, cam_bsdfs, pairs, stream, cfg, s1_only):
    """A light resampled at each camera vertex (NEE inside BDPT).  Returns
    (shadow rays (S, N), contrib (S, N, 3), ok (S, N), stream)."""
    t_arr = [t for (_, t) in pairs]
    S, n = len(pairs), cam.p.shape[0]
    pt = cam.gather([t - 1 for t in t_arr])
    ptm = cam.gather([t - 2 for t in t_arr])
    pt_bsdf = _gather_bsdfs(cam_bsdfs, [t - 1 for t in t_arr])

    # one (pick, light) draw per strategy, in ascending t
    u_picks, u_lights = [], []
    for _ in pairs:
        u_pick, stream = rng.next_1d(stream)
        u_light, stream = rng.next_2d(stream)
        u_picks.append(u_pick)
        u_lights.append(u_light)
    u_pick = torch.stack(u_picks, dim=0)  # (S, N)
    u_light = torch.stack(u_lights, dim=0)  # (S, N, 2)

    l_idx, pdf_choice = lt.pick_light(scene.lights, u_pick)
    ls = lt.sample_li(scene, l_idx, pt.p, u_light)

    wo_l = m.to_local(pt.t, pt.b, pt.ns, pt.wo)
    wi_l = m.to_local(pt.t, pt.b, pt.ns, ls.wi)
    f = uber.evaluate(pt_bsdf, wo_l, wi_l)
    cos_i = torch.abs(m.dot(pt.ns, ls.wi))
    ok = (pt.valid & (pt.vtype == VT_SURFACE) & ls.valid & ~m.is_black(f)
          & (scene.lights.num > 0))
    # one-sided geometric check
    ok = ok & ((m.dot(pt.ng, ls.wi) * m.dot(pt.ng, pt.wo)) > 0.0)

    srays = spawn_shadow_ray(_interaction_of(pt), ls.wi, ls.dist, cfg.trace_offset, ok)
    contrib = pt.beta * f * ls.li * m.safe_div(cos_i, ls.pdf * pdf_choice)[..., None]
    if s1_only:
        return srays, contrib, ok, stream

    # MIS: the sampled light vertex is each strategy's 1-vertex light path
    surf = torch.ones((S, n), dtype=torch.bool, device=cam.p.device)
    pdf_pos, _ = lt.pdf_le(scene, l_idx, ls.n, ls.wi)
    pt_rev = _pdf_light_dir_v(scene, torch.where(ok, l_idx, -1), ls.p, ls.n, pt.p, pt.ng,
                              surf)
    pt_minus_rev = _pdf_vertex(pt_bsdf, pt, ls.p, ptm.p, ptm.ng, ptm.on_surface)
    qs_rev = _pdf_vertex(pt_bsdf, pt, ptm.p, ls.p, ls.n, surf)
    zero = torch.zeros((S, n), dtype=torch.float32, device=cam.p.device)
    w = _mis_weights([1] * S, t_arr, cam, light, pt_rev, pt_minus_rev, qs_rev, zero,
                     light0_fwd=pdf_pos * pdf_choice, light0_rev=zero,
                     light0_delta=ls.is_delta, light0_valid=ok,
                     light0_is_delta=_is_delta_light(scene, l_idx))
    return srays, contrib * w[..., None], ok, stream


def _family_connect(scene, camera, cam, light, cam_bsdfs, light_bsdfs, pairs, cfg):
    """General (s >= 2, t >= 2) connections through the geometric term."""
    s_arr = [s for (s, _) in pairs]
    t_arr = [t for (_, t) in pairs]
    S, n = len(pairs), cam.p.shape[0]
    pt = cam.gather([t - 1 for t in t_arr])
    ptm = cam.gather([t - 2 for t in t_arr])
    qs = light.gather([s - 1 for s in s_arr])
    qsm = light.gather([s - 2 for s in s_arr])
    pt_bsdf = _gather_bsdfs(cam_bsdfs, [t - 1 for t in t_arr])
    qs_bsdf = _gather_bsdfs(light_bsdfs, [s - 1 for s in s_arr])

    ok = pt.valid & qs.valid & (pt.vtype == VT_SURFACE) & (qs.vtype == VT_SURFACE)
    d = qs.p - pt.p
    d2 = torch.clamp_min(m.length_sq(d), 1e-12)
    dist = torch.sqrt(d2)
    w_pt_to_qs = d / dist[..., None]

    f_pt = _eval_f(pt_bsdf, pt, w_pt_to_qs)
    f_qs = _eval_f(qs_bsdf, qs, -w_pt_to_qs)
    f_qs = f_qs * _shading_normal_correction(qs, -w_pt_to_qs)[..., None]
    g = _g_term(pt.p, pt.ns, qs.p, qs.ns)
    contrib = pt.beta * f_pt * g[..., None] * f_qs * qs.beta
    ok = ok & ~m.is_black(contrib)
    srays = spawn_shadow_ray(_interaction_of(pt), w_pt_to_qs, dist, cfg.trace_offset, ok)

    surf = torch.ones((S, n), dtype=torch.bool, device=cam.p.device)
    pt_rev = _pdf_vertex(qs_bsdf, qs, qsm.p, pt.p, pt.ng, surf)
    pt_minus_rev = _pdf_vertex(pt_bsdf, pt, qs.p, ptm.p, ptm.ng, ptm.on_surface)
    qs_rev = _pdf_vertex(pt_bsdf, pt, ptm.p, qs.p, qs.ng, surf)
    qs_minus_rev = _pdf_vertex(qs_bsdf, qs, pt.p, qsm.p, qsm.ng, qsm.on_surface)
    w = _mis_weights(s_arr, t_arr, cam, light, pt_rev, pt_minus_rev, qs_rev, qs_minus_rev,
                     *_light0_fields(scene, light, S))
    return srays, contrib * w[..., None], ok


def _family_t1(scene, camera, cam, light, light_bsdfs, pairs, cfg, n, film,
               slot_of_pixel):
    """Light vertices connected to the camera.  Returns (shadow rays,
    contrib, ok, splat slots), all (S, N)."""
    s_arr = [s for (s, _) in pairs]
    S = len(pairs)
    qs = light.gather([s - 1 for s in s_arr])
    qsm = light.gather([s - 2 for s in s_arr])
    qs_bsdf = _gather_bsdfs(light_bsdfs, [s - 1 for s in s_arr])

    wi, dist, we, pdf_cam, uv, inside = camera.sample_wi(qs.p)
    ok = qs.valid & (qs.vtype == VT_SURFACE) & inside & (we > 0.0)
    f = _eval_f(qs_bsdf, qs, wi) * _shading_normal_correction(qs, wi)[..., None]
    cos_i = torch.abs(m.dot(qs.ns, wi))
    ok = ok & ~m.is_black(f)
    srays = spawn_shadow_ray(_interaction_of(qs), wi, dist, cfg.trace_offset, ok)
    contrib = qs.beta * f * (we * m.safe_div(cos_i, pdf_cam))[..., None]

    # MIS: the camera side is the lone eye vertex; the light side walks fully
    surf = torch.ones((S, n), dtype=torch.bool, device=qs.p.device)
    cam_pos = camera.position.expand((S, n, 3))
    w_dir = m.normalize(qs.p - cam_pos)
    _, pdf_dir = camera.pdf_we(w_dir)
    qs_rev = _convert_density(pdf_dir, cam_pos, qs.p, qs.ng, surf)
    qs_minus_rev = _pdf_vertex(qs_bsdf, qs, cam_pos, qsm.p, qsm.ng, qsm.on_surface)
    zero = torch.zeros((S, n), dtype=torch.float32, device=qs.p.device)
    w = _mis_weights(s_arr, [1] * S, cam, light, zero, zero, qs_rev, qs_minus_rev,
                     *_light0_fields(scene, light, S))
    contrib = contrib * w[..., None]

    # splat slots: the row-major pixel (v = 0 the bottom row) of the film
    # (W, H); direct callers without one get a square film of sqrt(n)
    if film is not None:
        w_img, h_img = film
    else:
        w_img = math.isqrt(n)
        h_img = n // w_img
    px = (uv[..., 0] * w_img).to(torch.int32).clamp(0, w_img - 1)
    py = (uv[..., 1] * h_img).to(torch.int32).clamp(0, h_img - 1)
    flat = (py * w_img + px).long()
    if slot_of_pixel is not None:
        # rays are a permutation of pixels: the splat goes to the ray slot
        # that the caller's inverse permutation maps back to pixel `flat`
        flat = slot_of_pixel[flat]
    return srays, contrib, ok, flat


def _splat(L: torch.Tensor, flat: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """``L`` plus the (S, N, 3) t=1 contributions added into the ray slots
    ``flat``: a scatter-add (float atomics on the card), out of place, whose
    backward gathers the cotangent of ``L`` at ``flat``."""
    return L.index_add(0, flat.reshape(-1), contrib.reshape(-1, 3))


def _rays_map(fn, *rays: Rays) -> Rays:
    return Rays(**{f.name: fn(*(getattr(r, f.name) for r in rays))
                   for f in dataclasses.fields(Rays)})


def _chunked_occlusion(scene, occluded, srays: Rays, n: int) -> torch.Tensor:
    """Resolve an (S, N) table of shadow rays by occlusion queries of at
    most ``OCC_CHUNK_RAYS`` rays each.  Returns blocked (S, N) bool."""
    S = srays.o.shape[0]
    per = max(1, OCC_CHUNK_RAYS // max(n, 1))
    outs = []
    for lo in range(0, S, per):
        hi = min(S, lo + per)
        chunk = _rays_map(lambda a: a[lo:hi].reshape(((hi - lo) * n,) + a.shape[2:]), srays)
        outs.append(occluded(scene, chunk).reshape(hi - lo, n))
    return torch.cat(outs, dim=0)


def strategy_pairs(max_depth: int):
    """The static (s, t) tables of the four families, in the reference's
    per-pixel enumeration order: (s=0, s=1, s>=2 and t>=2, t=1)."""
    t_max, s_max = max_depth + 2, max_depth + 1

    def in_range(s, t):
        return 0 <= s + t - 2 <= max_depth

    s0 = [(0, t) for t in range(2, t_max + 1) if in_range(0, t)]
    s1 = [(1, t) for t in range(2, t_max + 1) if in_range(1, t)]
    conn = [(s, t) for t in range(2, t_max + 1) for s in range(2, s_max + 1)
            if in_range(s, t)]
    t1 = [(s, 1) for s in range(2, s_max + 1) if in_range(s, 1)]
    return s0, s1, conn, t1


def trace(scene: Scene, camera: PinholeCamera, rays: Rays, stream: rng.SampleStream,
          cfg: IntegratorConfig, intersect, occluded, s1_only: bool = False,
          film: tuple[int, int] | None = None,
          slot_of_pixel: torch.Tensor | None = None, share=None) -> torch.Tensor:
    """The full BDPT estimate of one wavefront: (N, 3) radiance, the t=1
    film splats included.

    ``s1_only`` keeps only the s=1 strategies, which reproduce the forward
    path tracer's NEE estimate.  ``film`` is the (W, H) resolution the t=1
    splats address (a square film of sqrt(n) by default); ``slot_of_pixel``
    maps a row-major pixel to the ray slot carrying it, for callers that
    trace the pixels in another order (the renderer's Morton order).

    ``share`` (a ``renderer.SlotSlice``) says the rays are slots lo..hi of
    a wavefront of ``len(slot_of_pixel)`` slots (a rays-sharded render).
    Their t=1 splats then go to a film of every slot, which
    ``share.reduce_film`` completes with the other ranks' before the lanes
    lo..hi are added to the slice's radiance."""
    n = rays.n
    cam, stream, cam_bsdfs = generate_camera_subpath(scene, camera, rays, stream,
                                                     cfg.max_depth + 2, cfg, intersect)
    light, stream, light_bsdfs = generate_light_subpath(scene, stream, cfg.max_depth + 1,
                                                        cfg, intersect, n)
    s0_pairs, s1_pairs, conn_pairs, t1_pairs = strategy_pairs(cfg.max_depth)

    L = torch.zeros((n, 3), dtype=torch.float32, device=rays.o.device)
    if not s1_only and s0_pairs:
        L = L + _family_s0(scene, camera, cam, light, cam_bsdfs, s0_pairs)

    # deferred visibility: every connecting family stages (shadow rays,
    # weighted contrib, ok), and chunked occlusion queries resolve them
    blocks = []
    if s1_pairs:
        srays, contrib, ok, stream = _family_s1(scene, camera, cam, light, cam_bsdfs,
                                                s1_pairs, stream, cfg, s1_only)
        blocks.append((srays, contrib, ok, None))
    if not s1_only and conn_pairs:
        blocks.append(_family_connect(scene, camera, cam, light, cam_bsdfs, light_bsdfs,
                                      conn_pairs, cfg) + (None,))
    if not s1_only and t1_pairs:
        blocks.append(_family_t1(scene, camera, cam, light, light_bsdfs, t1_pairs, cfg, n,
                                 film, slot_of_pixel))

    if blocks:
        all_rays = _rays_map(lambda *xs: torch.cat(xs, dim=0), *[b[0] for b in blocks])
        blocked = _chunked_occlusion(scene, occluded, all_rays, n)
        row = 0
        for srays, contrib, ok, flat in blocks:
            S = srays.o.shape[0]
            vis = ok & ~blocked[row:row + S]
            row += S
            masked = torch.where(vis[..., None], contrib, 0.0)
            if flat is None:
                L = L + torch.sum(masked, dim=0)
            elif share is None:
                L = _splat(L, flat, masked)
            else:
                splats = share.reduce_film(
                    _splat(L.new_zeros((slot_of_pixel.shape[0], 3)), flat, masked))
                L = L + splats[share.lo:share.hi]
    return L
