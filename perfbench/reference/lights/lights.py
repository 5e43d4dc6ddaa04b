"""Light library (counterpart of ``mcrt_tpu/lights/lights.py``): uniform
light pick, ``sample_li`` for directional, point, disk and triangle-mesh
area lights, ``pdf_li`` and ``eval_le`` for next-event estimation, and
the emission sampling of BDPT's light subpaths, ``sample_le`` and
``pdf_le``.  All light types are evaluated per lane and selected by type,
over any leading shape of the light ids."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import math as m
from ..core.types import TensorRecord
from ..sampling import samplers as smp
from ..scene.scene import (LIGHT_DIRECTIONAL, LIGHT_DISK, LIGHT_MESH,
                           LIGHT_POINT, Lights, Scene, take_clip)


@dataclass
class LightSample(TensorRecord):
    li: torch.Tensor  # (N, 3) incident radiance
    wi: torch.Tensor  # (N, 3) unit direction from the ref point to the light
    pdf: torch.Tensor  # (N,) solid-angle pdf (1 for delta lights)
    dist: torch.Tensor  # (N,) distance to the sample (shadow tmax)
    p: torch.Tensor  # (N, 3) sampled point
    n: torch.Tensor  # (N, 3) light normal at the sample
    is_delta: torch.Tensor  # (N,) bool
    valid: torch.Tensor  # (N,) bool


def pick_light(lights: Lights, u: torch.Tensor):
    """Uniform light pick: (light index, choice pdf)."""
    if lights.capacity == 0:
        return torch.zeros_like(u, dtype=torch.int32), torch.zeros_like(u)
    num = max(lights.num, 1)
    idx = torch.clamp((u * num).to(torch.int32), 0, num - 1)
    return idx, torch.full_like(u, 1.0 / num)


def _sample_mesh_point(scene: Scene, light_idx: torch.Tensor, u2: torch.Tensor):
    """Area-weighted triangle pick over one global monotone CDF (entry j of
    light l holds l + cdf_j), then a uniform point on the triangle."""
    lights = scene.lights
    lt = lights.tri_cdf.shape[0]
    if lt == 0:
        z = torch.zeros(light_idx.shape + (3,), dtype=torch.float32,
                        device=light_idx.device)
        return z, z, torch.zeros_like(light_idx)
    gcdf = lights.tri_light.to(torch.float32) + lights.tri_cdf
    lf = light_idx.to(torch.float32)
    target = lf + torch.clamp(u2[..., 0], 0.0, 1.0 - 1e-7)
    j = torch.clamp(torch.searchsorted(gcdf, target, right=False), 0, lt - 1)
    prim = lights.tri_index[j]
    p0, p1, p2 = scene.geometry.face_vertices(prim)
    lo = torch.where(j == 0, lf, gcdf[torch.clamp_min(j - 1, 0)])
    lo = torch.maximum(lo, lf)
    hi = gcdf[j]
    u0r = m.safe_div(target - lo, hi - lo)
    bary = smp.uniform_triangle(torch.stack([u0r, u2[..., 1]], dim=-1))
    p = p0 + (p1 - p0) * bary[..., 0:1] + (p2 - p0) * bary[..., 1:2]
    ng = m.normalize(m.cross(p1 - p0, p2 - p0))
    return p, ng, prim


def _empty_light_sample(light_idx: torch.Tensor) -> LightSample:
    """The sample of a scene without lights, shaped as the light ids."""
    shape, device = light_idx.shape, light_idx.device
    z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=device)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    f = torch.zeros(shape, dtype=torch.bool, device=device)
    wi = z3.clone()
    wi[..., 1] = 1.0
    return LightSample(li=z3, wi=wi, pdf=z, dist=z, p=z3, n=z3, is_delta=f, valid=f)


def sample_li(scene: Scene, light_idx: torch.Tensor, ref_p: torch.Tensor,
              u2: torch.Tensor) -> LightSample:
    """Sample incident direction and radiance from light ``light_idx`` at
    ``ref_p``."""
    lights = scene.lights
    if lights.capacity == 0:
        return _empty_light_sample(light_idx)
    ltype = take_clip(lights.type, light_idx)
    lpos = take_clip(lights.position, light_idx)
    ldir = take_clip(lights.direction, light_idx)
    lint = take_clip(lights.intensity, light_idx)
    lrad = take_clip(lights.radius, light_idx)
    larea = take_clip(lights.area, light_idx)
    scene_diam = 2.0 * scene.radius

    wi_dir = -ldir
    p_dir = ref_p + wi_dir * scene_diam
    t_disk, b_disk = m.build_orthonormal_basis(ldir)
    dxy = smp.concentric_disk(u2) * lrad[..., None]
    p_disk = lpos + t_disk * dxy[..., 0:1] + b_disk * dxy[..., 1:2]
    p_mesh, n_mesh, _ = _sample_mesh_point(scene, light_idx, u2)

    is_dir = ltype == LIGHT_DIRECTIONAL
    is_pt = ltype == LIGHT_POINT
    is_disk = ltype == LIGHT_DISK
    is_mesh = ltype == LIGHT_MESH
    is_delta = is_dir | is_pt
    is_area = is_disk | is_mesh

    p = torch.where(is_dir[..., None], p_dir, torch.where(
        is_pt[..., None], lpos, torch.where(is_disk[..., None], p_disk, p_mesh)))
    n = torch.where(is_mesh[..., None], n_mesh, ldir)
    to_l = p - ref_p
    d2 = m.fmax(m.length_sq(to_l), 1e-12)
    dist = torch.sqrt(d2)
    wi = torch.where(is_dir[..., None], wi_dir, to_l / dist[..., None])
    cos_l = m.dot(n, -wi)
    front = cos_l > 1e-6
    li = torch.where(is_dir[..., None], lint, torch.where(
        is_pt[..., None], lint / d2[..., None], torch.where(front[..., None], lint, 0.0)))
    pdf_area = m.safe_div(torch.ones_like(d2), larea)
    pdf = torch.where(is_delta, 1.0, m.safe_div(d2 * pdf_area, torch.abs(cos_l)))
    valid = (is_delta | (is_area & front)) & (pdf > 0.0)
    dist = torch.where(is_dir, scene_diam, dist)
    return LightSample(li=torch.where(valid[..., None], li, 0.0), wi=wi,
                       pdf=torch.where(valid, pdf, 0.0), dist=dist, p=p, n=n,
                       is_delta=is_delta, valid=valid)


def pdf_li(scene: Scene, light_idx: torch.Tensor, ref_p: torch.Tensor,
           wi: torch.Tensor, hit_p: torch.Tensor, hit_n: torch.Tensor):
    """Solid-angle pdf of ``sample_li`` producing ``wi`` (area lights; delta
    lights give 0)."""
    lights = scene.lights
    if lights.capacity == 0:
        return torch.zeros(light_idx.shape, dtype=torch.float32, device=light_idx.device)
    ltype = take_clip(lights.type, light_idx)
    larea = take_clip(lights.area, light_idx)
    is_area = (ltype == LIGHT_DISK) | (ltype == LIGHT_MESH)
    d2 = m.distance_sq(ref_p, hit_p)
    cos_l = torch.abs(m.dot(hit_n, -wi))
    return torch.where(is_area, m.safe_div(d2, cos_l * larea), 0.0)


def eval_le(scene: Scene, light_idx: torch.Tensor, n: torch.Tensor,
            wo: torch.Tensor) -> torch.Tensor:
    """Emitted radiance of an area light toward wo (one-sided)."""
    if scene.lights.capacity == 0:
        return torch.zeros(light_idx.shape + (3,), dtype=torch.float32,
                           device=light_idx.device)
    lint = take_clip(scene.lights.intensity, light_idx)
    ok = (light_idx >= 0) & (m.dot(n, wo) > 0.0)
    return torch.where(ok[..., None], lint, 0.0)


@dataclass
class LeSample(TensorRecord):
    """An emitted ray of a BDPT light subpath."""

    le: torch.Tensor  # (N, 3)
    p: torch.Tensor  # (N, 3) origin on the light
    n: torch.Tensor  # (N, 3) light normal at the origin
    d: torch.Tensor  # (N, 3) emitted direction
    pdf_pos: torch.Tensor  # (N,)
    pdf_dir: torch.Tensor  # (N,)
    is_delta_pos: torch.Tensor  # (N,) point lights
    is_delta_dir: torch.Tensor  # (N,) directional lights
    valid: torch.Tensor  # (N,) bool


def _disk_pdf(scene: Scene, like: torch.Tensor) -> torch.Tensor:
    """1/(pi r^2) of the scene-radius disk directional lights start on."""
    return m.safe_div(torch.ones_like(like), math.pi * (scene.radius * scene.radius))


def sample_le(scene: Scene, light_idx: torch.Tensor, u_pos: torch.Tensor,
              u_dir: torch.Tensor) -> LeSample:
    """Sample a ray leaving light ``light_idx``: uniform-sphere directions
    for point lights, cosine-hemisphere directions about the normal for
    area lights; directional lights start on a disk of the scene's radius
    outside the scene."""
    lights = scene.lights
    ltype = take_clip(lights.type, light_idx)
    lpos = take_clip(lights.position, light_idx)
    ldir = take_clip(lights.direction, light_idx)
    lint = take_clip(lights.intensity, light_idx)
    lrad = take_clip(lights.radius, light_idx)
    larea = take_clip(lights.area, light_idx)

    is_dir = ltype == LIGHT_DIRECTIONAL
    is_pt = ltype == LIGHT_POINT
    is_disk = ltype == LIGHT_DISK
    is_mesh = ltype == LIGHT_MESH

    t_d, b_d = m.build_orthonormal_basis(ldir)
    dxy = smp.concentric_disk(u_pos) * lrad[..., None]
    p_disk = lpos + t_d * dxy[..., 0:1] + b_d * dxy[..., 1:2]
    p_mesh, n_mesh, _ = _sample_mesh_point(scene, light_idx, u_pos)
    disk2 = smp.concentric_disk(u_pos) * scene.radius
    p_inf = (scene.center + (t_d * disk2[..., 0:1] + b_d * disk2[..., 1:2])
             - ldir * (2.0 * scene.radius))
    p = torch.where(is_dir[..., None], p_inf, torch.where(
        is_pt[..., None], lpos, torch.where(is_disk[..., None], p_disk, p_mesh)))
    n = torch.where(is_mesh[..., None], n_mesh, ldir)

    d_sph = smp.uniform_sphere(u_dir)
    t_n, b_n = m.build_orthonormal_basis(n)
    d_cos = m.to_world(t_n, b_n, n, smp.cosine_hemisphere(u_dir))
    d = torch.where(is_dir[..., None], ldir, torch.where(is_pt[..., None], d_sph, d_cos))

    cos_d = m.dot(n, d)
    pdf_pos = torch.where(is_dir, _disk_pdf(scene, larea), torch.where(
        is_pt, 1.0, m.safe_div(torch.ones_like(larea), larea)))
    pdf_dir = torch.where(is_dir, 1.0, torch.where(
        is_pt, smp.uniform_sphere_pdf(), smp.cosine_hemisphere_pdf(cos_d)))
    le = torch.where(is_dir[..., None] | is_pt[..., None], lint,
                     torch.where((cos_d > 0.0)[..., None], lint, 0.0))
    valid = (light_idx >= 0) & (pdf_pos > 0.0) & (pdf_dir > 0.0)
    return LeSample(le=le, p=p, n=n, d=d, pdf_pos=pdf_pos, pdf_dir=pdf_dir,
                    is_delta_pos=is_pt, is_delta_dir=is_dir, valid=valid)


def pdf_le(scene: Scene, light_idx: torch.Tensor, n: torch.Tensor, d: torch.Tensor):
    """(pdf_pos, pdf_dir) of ``sample_le`` emitting direction d, as MIS
    reads them: the delta parts are 0 (a directional light's pdf_dir, a
    point light's pdf_pos), which the BDPT ratio walk remaps to 1."""
    lights = scene.lights
    ltype = take_clip(lights.type, light_idx)
    larea = take_clip(lights.area, light_idx)
    is_dir = ltype == LIGHT_DIRECTIONAL
    is_pt = ltype == LIGHT_POINT
    cos_d = m.dot(n, d)
    pdf_pos = torch.where(is_dir, _disk_pdf(scene, larea), torch.where(
        is_pt, 0.0, m.safe_div(torch.ones_like(larea), larea)))
    pdf_dir = torch.where(is_dir, 0.0, torch.where(
        is_pt, smp.uniform_sphere_pdf(), smp.cosine_hemisphere_pdf(cos_d)))
    return pdf_pos, pdf_dir
