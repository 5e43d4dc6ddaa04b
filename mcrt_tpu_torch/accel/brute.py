"""Brute-force O(N·T) ray-triangle intersector (counterpart of
``mcrt_tpu/accel/brute.py``).

The conformance oracle: every ray against every triangle, in chunks of
triangles, with a running minimum.  It shares no code with the blocked
path (no packing, no coherence sort, no ``_resolve_uv``), so holding the
blocked queries against it checks the whole query path against an
independent answer.

The answer is the globally first triangle of least t, whatever the chunk
size: ``torch.argmin`` returns the first minimal index, a hit must beat
the running best strictly (``t < best_t``, inside a chunk and across
chunks), and the best starts at ``F32_MAX`` while a hit needs
``t < tmax``.  The chunk size is therefore free: by default a chunk holds
about ``CHUNK_ELEMS`` (ray, triangle) pairs, which bounds each of the
chunk's (N, chunk) float temporaries.

No gradient flows through the search (intersection is a discrete event):
it runs on detached rays and positions.  Where the rays carry a graph,
``attach_uv`` gives the winner's barycentrics the gradient in the rays
that the blocked queries' ``_resolve_uv`` gives, the values unchanged.
"""
from __future__ import annotations

import torch

from ..core.types import F32_MAX, Hit, Rays
from ..scene.scene import Geometry, take_clip

CHUNK_ELEMS = 1 << 22  # (ray, triangle) pairs a chunk holds by default
_DET_EPS = 1e-9


def default_chunk(n_rays: int, num_faces: int) -> int:
    """Triangles a chunk tests: ``CHUNK_ELEMS`` pairs, at least 1, at most
    every face."""
    return max(1, min(num_faces, CHUNK_ELEMS // max(n_rays, 1)))


def _gather_chunk(geom: Geometry, start: int, chunk: int):
    """(p0, p1, p2, valid, idx) of faces ``start .. start+chunk``: indices
    past the end are clipped for the vertex gathers (``mode="clip"``) and
    invalid (``mode="fill"``)."""
    dev = geom.indices.device
    idx = start + torch.arange(chunk, device=dev)
    n = geom.num_faces
    inside = idx < n
    tri = take_clip(geom.indices, idx)
    valid = torch.where(inside, take_clip(geom.face_valid, idx), False)
    pos = geom.positions.detach()
    p0, p1, p2 = (take_clip(pos, tri[:, k]) for k in range(3))
    return p0, p1, p2, valid, idx


def moller_trumbore(o, d, p0, p1, p2, eps: float = _DET_EPS):
    """Branch-free Moller-Trumbore of ``o``, ``d`` against ``p0``, ``p1``,
    ``p2``, each a triple of broadcastable component tensors; returns
    (t, u, v, hit).  The JAX package's arithmetic: cross products, dot
    products summed x + y + z, a 1e-9 determinant guard."""
    (ox, oy, oz), (dx, dy, dz) = o, d
    e1 = [b - a for a, b in zip(p0, p1)]
    e2 = [b - a for a, b in zip(p0, p2)]
    return mt_edges(ox, oy, oz, dx, dy, dz, p0, e1, e2, eps)


def mt_edges(ox, oy, oz, dx, dy, dz, p0, e1, e2, eps: float = _DET_EPS):
    """Moller-Trumbore on precomputed edges ``e1 = p1 - p0``, ``e2 = p2 -
    p0`` (each of ``p0``, ``e1``, ``e2`` a triple of components)."""
    pvx = dy * e2[2] - dz * e2[1]
    pvy = dz * e2[0] - dx * e2[2]
    pvz = dx * e2[1] - dy * e2[0]
    det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
    ok = torch.abs(det) > eps
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx, tvy, tvz = ox - p0[0], oy - p0[1], oz - p0[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1[2] - tvz * e1[1]
    qvy = tvz * e1[0] - tvx * e1[2]
    qvz = tvx * e1[1] - tvy * e1[0]
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def needs_uv_grad(rays: Rays) -> bool:
    """Whether a query's barycentrics must carry a gradient in ``rays``."""
    return torch.is_grad_enabled() and (rays.o.requires_grad or rays.d.requires_grad)


def attach_uv(u, v, found, rays: Rays, p0, e1, e2):
    """``u``, ``v`` (the query's values, unchanged) carrying the gradient,
    in the rays' origins and directions, of the winning triangle's
    barycentrics (``p0``, ``e1``, ``e2``: (N, 3), constant), as the
    blocked queries' ``_resolve_uv`` carries it."""
    cols = [tuple(x[:, k] for k in range(3)) for x in (rays.o, rays.d, p0, e1, e2)]
    _, ur, vr, _ = mt_edges(*cols[0], *cols[1], *cols[2:])
    return (u + torch.where(found, ur - ur.detach(), 0.0),
            v + torch.where(found, vr - vr.detach(), 0.0))


def _chunks(geom: Geometry, rays: Rays, chunk: int | None):
    """Per chunk of faces: (t, u, v, hit, face ids), each (N, chunk) but the
    ids, rays along the rows."""
    chunk = chunk or default_chunk(rays.n, geom.num_faces)
    o, d = ([c[:, None] for c in x.detach().unbind(1)] for x in (rays.o, rays.d))
    tmin, tmax = rays.tmin.detach()[:, None], rays.tmax.detach()[:, None]
    for start in range(0, geom.num_faces, chunk):
        *p, cvalid, idx = _gather_chunk(geom, start, chunk)
        t, u, v, hit = moller_trumbore(o, d, *([c[None, :] for c in x.unbind(1)] for x in p))
        yield t, u, v, hit & cvalid[None, :] & (t > tmin) & (t < tmax), idx


def intersect_brute(geom: Geometry, rays: Rays, chunk: int | None = None) -> Hit:
    """Closest-hit query against every triangle."""
    n, dev = rays.n, rays.o.device
    best_t = torch.full((n,), F32_MAX, dtype=torch.float32, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    for t, u, v, hit, idx in _chunks(geom, rays, chunk):
        t_masked = torch.where(hit & (t < best_t[:, None]), t, F32_MAX)
        j = torch.argmin(t_masked, dim=1, keepdim=True)  # the first least t
        t_new = t_masked.gather(1, j)[:, 0]
        better = t_new < best_t
        best_prim = torch.where(better, idx[j[:, 0]].to(torch.int32), best_prim)
        best_u = torch.where(better, u.gather(1, j)[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, j)[:, 0], best_v)
        best_t = torch.where(better, t_new, best_t)
    found = best_prim >= 0
    valid = found & rays.active
    if needs_uv_grad(rays):
        p0, p1, p2 = (x.detach() for x in geom.face_vertices(best_prim.clamp_min(0)))
        best_u, best_v = attach_uv(best_u, best_v, found, rays, p0, p1 - p0, p2 - p0)
    shape = torch.where(valid, take_clip(geom.face_shape, best_prim.clamp_min(0)), -1)
    return Hit(t=torch.where(valid, best_t, F32_MAX), prim=torch.where(valid, best_prim, -1),
               shape=shape.to(torch.int32), u=best_u, v=best_v, valid=valid)


def occluded_brute(geom: Geometry, rays: Rays, chunk: int | None = None) -> torch.Tensor:
    """Any-hit query: (N,) bool, True where the segment (tmin, tmax) is
    blocked."""
    blocked = torch.zeros((rays.n,), dtype=torch.bool, device=rays.o.device)
    for _, _, _, hit, _ in _chunks(geom, rays, chunk):
        blocked = blocked | hit.any(dim=1)
    return blocked & rays.active
