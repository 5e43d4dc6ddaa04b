"""Surface interaction construction from hit records (counterpart of
``mcrt_tpu/scene/interaction.py``): triangle dpdu/dpdv from UVs, packed
per-face attribute fetch and interpolation, the ray-differential transfer
onto the hit plane, and the geometric-offset ray spawns."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.types import Hit, Interaction, RayDiff, Rays
from .scene import (FA_LIGHT, FA_MAT, FA_N0, FA_N1, FA_N2, FA_P0, FA_P1, FA_P2,
                    FA_UV0, FA_UV1, FA_UV2, Scene, take_clip)


def _face_attributes(scene: Scene, prim: torch.Tensor):
    """One packed row gather per hit: (p[3], n[3], uv[3], mat, light)."""
    row = take_clip(scene.geometry.face_attrs, prim)
    p = [row[..., FA_P0:FA_P0 + 3], row[..., FA_P1:FA_P1 + 3],
         row[..., FA_P2:FA_P2 + 3]]
    n = [row[..., FA_N0:FA_N0 + 3], row[..., FA_N1:FA_N1 + 3],
         row[..., FA_N2:FA_N2 + 3]]
    uv = [row[..., FA_UV0:FA_UV0 + 2], row[..., FA_UV1:FA_UV1 + 2],
          row[..., FA_UV2:FA_UV2 + 2]]
    mat = row[..., FA_MAT].to(torch.int32)
    light = row[..., FA_LIGHT].to(torch.int32)
    return p, n, uv, mat, light


def triangle_dpduv(p, uv):
    """dpdu/dpdv from the uv parametrization; an ONB around the geometric
    normal for degenerate UVs.  Returns (dpdu, dpdv, ng)."""
    duv02 = uv[0] - uv[2]
    duv12 = uv[1] - uv[2]
    dp02 = p[0] - p[2]
    dp12 = p[1] - p[2]
    det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)[..., None]
    dpdu = (duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12) * inv
    dpdv = (-duv12[..., 0:1] * dp02 + duv02[..., 0:1] * dp12) * inv
    ng = m.normalize(m.cross(p[1] - p[0], p[2] - p[0]))
    t_fb, b_fb = m.build_orthonormal_basis(ng)
    dpdu = torch.where(ok[..., None], dpdu, t_fb)
    dpdv = torch.where(ok[..., None], dpdv, b_fb)
    return dpdu, dpdv, ng


def transfer_differentials(rays: Rays, diff: RayDiff, p, ng, dpdu, dpdv):
    """Ray-differential transfer onto the hit plane -> (duvdx, duvdy): the
    neighbour-pixel rays meet the plane through ``p`` with normal ``ng``,
    then the uv offsets come from least-squares normal equations in the
    raw dpdu/dpdv parametrization."""
    denom = m.dot(rays.d, ng)
    dist = m.dot(p - rays.o, ng)

    def plane_offset(dd):
        dn = m.dot(dd, ng)
        ok = torch.abs(dn) > 1e-12
        t = torch.where(ok, dist / torch.where(ok, dn, 1.0), 0.0)
        return rays.o + dd * t[..., None] - p, ok

    dpdx, okx = plane_offset(diff.dddx)
    dpdy, oky = plane_offset(diff.dddy)
    uu = m.dot(dpdu, dpdu)
    uvd = m.dot(dpdu, dpdv)
    vv = m.dot(dpdv, dpdv)
    ok0 = torch.abs(denom) > 1e-12

    def solve(dp, ok):
        du, dv, s_ok = m.solve_2x2(uu, uvd, uvd, vv, m.dot(dp, dpdu), m.dot(dp, dpdv))
        good = ok & ok0 & s_ok
        return torch.stack([torch.where(good, du, 0.0), torch.where(good, dv, 0.0)], dim=-1)

    return solve(dpdx, okx), solve(dpdy, oky)


def compute_interaction(scene: Scene, rays: Rays, hit: Hit,
                        diff: RayDiff | None = None) -> Interaction:
    """The shading record at each hit; invalid lanes get benign defaults.
    With ``diff``, the uv screen footprint is transferred onto the hit
    plane (it drives texture LOD once textures are ported)."""
    if scene.geometry.instanced:
        raise NotImplementedError("instanced scenes are not ported yet (ROADMAP)")
    p3, n3, uv3, mat, light = _face_attributes(scene, hit.prim.clamp_min(0))
    b1 = hit.u[..., None]
    b2 = hit.v[..., None]
    b0 = 1.0 - b1 - b2
    pos = p3[0] * b0 + p3[1] * b1 + p3[2] * b2
    ns = m.normalize(n3[0] * b0 + n3[1] * b1 + n3[2] * b2)
    uv = uv3[0] * b0 + uv3[1] * b1 + uv3[2] * b2

    dpdu, dpdv, ng = triangle_dpduv(p3, uv3)
    ng = torch.where(m.dot3(ng, ns) < 0.0, -ng, ng)
    t = m.normalize(dpdu - ns * m.dot3(dpdu, ns))
    b = m.cross(ns, t)
    valid = hit.valid
    duvdx = duvdy = None
    if diff is not None:
        duvdx, duvdy = transfer_differentials(rays, diff, pos, ng, dpdu, dpdv)
        duvdx = torch.where(valid[..., None], duvdx, 0.0)
        duvdy = torch.where(valid[..., None], duvdy, 0.0)
    return Interaction(
        p=pos, ng=ng, ns=ns, dpdu=t, dpdv=b, uv=uv, wo=-rays.d,
        duvdx=duvdx, duvdy=duvdy,
        material=torch.where(valid, mat, -1).to(torch.int32),
        light=torch.where(valid, light, -1).to(torch.int32),
        valid=valid,
    )


def spawn_ray(it: Interaction, d: torch.Tensor, offset: float, tmax: float,
              active: torch.Tensor) -> Rays:
    """Offset the origin along the geometric normal, sign-flipped for
    transmission."""
    side = torch.where(m.dot(it.ng, d) >= 0.0, 1.0, -1.0)
    o = it.p + it.ng * (side * offset)[..., None]
    n = o.shape[0]
    return Rays(o=o, d=d,
                tmin=torch.zeros((n,), dtype=torch.float32, device=o.device),
                tmax=torch.full((n,), float(tmax), dtype=torch.float32, device=o.device),
                active=active)


def spawn_shadow_ray(it: Interaction, wi: torch.Tensor, dist: torch.Tensor,
                     offset: float, active: torch.Tensor) -> Rays:
    """Shadow ray toward a light sample, clipped short of the light."""
    side = torch.where(m.dot(it.ng, wi) >= 0.0, 1.0, -1.0)
    o = it.p + it.ng * (side * offset)[..., None]
    return Rays(o=o, d=wi, tmin=torch.zeros_like(dist),
                tmax=torch.clamp_min(dist - 2.0 * offset, 0.0), active=active)
