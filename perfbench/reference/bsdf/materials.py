"""Material dispatch (counterpart of ``mcrt_tpu/bsdf/materials.py``):
per-hit uber-material property fetch, texture modulation and normal
mapping.

Texture slots that no material binds are skipped entirely: the static
``materials.used_slots`` mask decides which slots are sampled at all."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.types import Interaction
from ..scene.scene import (N_TEX_SLOTS, TEX_DIFFUSE, TEX_GLOSSY, TEX_IOR,  # noqa: F401
                           TEX_KR, TEX_KT, TEX_NORMAL, TEX_OPACITY, TEX_ROUGHNESS, Scene,
                           take_clip)
from ..scene.textures import sample_texture
from . import bxdfs as bx
from .uber import UberBSDF


def _maybe_texture(scene: Scene, tex_id: torch.Tensor, uv: torch.Tensor,
                   duvdx, duvdy, default: torch.Tensor):
    """The texture's (rgb, alpha) where ``tex_id >= 0``, else (``default``,
    1)."""
    if scene.textures.num == 0:
        return default, torch.ones_like(default[..., :1])
    rgba = sample_texture(scene.textures, tex_id, uv, duvdx, duvdy)
    ok = (tex_id >= 0)[..., None]
    rgb = torch.where(ok, rgba[..., :3], default)
    alpha = torch.where(ok[..., 0], rgba[..., 3], 1.0)
    return rgb, alpha[..., None]


def fetch_bsdf(scene: Scene, it: Interaction,
               dist: int = bx.TROWBRIDGE_REITZ) -> tuple[UberBSDF, Interaction]:
    """Gather material parameters at each interaction and apply normal
    mapping.  Returns (bsdf, interaction with the perturbed frame).  A
    texture multiplies its constant; the diffuse texture's alpha multiplies
    the opacity."""
    mats = scene.materials
    mid = it.material.clamp_min(0)

    def g(arr):
        return take_clip(arr, mid)

    diffuse, glossy, kr, kt = g(mats.diffuse), g(mats.glossy), g(mats.kr), g(mats.kt)
    opacity, roughness, ior = g(mats.opacity), g(mats.roughness), g(mats.ior)

    if scene.textures.num > 0:
        used = mats.used_slots
        tex = g(mats.tex)  # (N, 8)
        one3 = torch.ones_like(diffuse)

        def slot(s):
            return _maybe_texture(scene, tex[..., s], it.uv, it.duvdx, it.duvdy, one3)

        d_a = torch.ones_like(diffuse[..., :1])
        if used[TEX_DIFFUSE]:
            d_rgb, d_a = slot(TEX_DIFFUSE)
            diffuse = diffuse * d_rgb
        if used[TEX_GLOSSY]:
            glossy = glossy * slot(TEX_GLOSSY)[0]
        if used[TEX_KR]:
            kr = kr * slot(TEX_KR)[0]
        if used[TEX_KT]:
            kt = kt * slot(TEX_KT)[0]
        if used[TEX_OPACITY] or used[TEX_DIFFUSE]:
            op_rgb = slot(TEX_OPACITY)[0] if used[TEX_OPACITY] else one3
            opacity = opacity * op_rgb * d_a
        if used[TEX_ROUGHNESS]:
            roughness = roughness * slot(TEX_ROUGHNESS)[0][..., 0]
        if used[TEX_IOR]:
            i_rgb, _ = slot(TEX_IOR)
            ior = torch.where(tex[..., TEX_IOR] >= 0, i_rgb[..., 0] * ior, ior)
        if used[TEX_NORMAL]:
            # tangent-space normal map (z up): perturb ns, then
            # re-orthonormalize the shading frame around it
            n_rgb, _ = slot(TEX_NORMAL)
            has_nm = tex[..., TEX_NORMAL] >= 0
            n_ts = m.normalize(n_rgb * 2.0 - 1.0)
            ns_new = m.normalize(it.dpdu * n_ts[..., 0:1] + it.dpdv * n_ts[..., 1:2]
                                 + it.ns * n_ts[..., 2:3])
            ns = torch.where(has_nm[..., None], ns_new, it.ns)
            t = m.normalize(it.dpdu - ns * m.dot3(it.dpdu, ns))
            it = it.replace(ns=ns, dpdu=t, dpdv=m.cross(ns, t))

    bsdf = UberBSDF(
        diffuse=diffuse, glossy=glossy, kr=kr, kt=kt,
        passthrough=m.fclip(1.0 - opacity, 0.0, 1.0),
        alpha=bx.roughness_to_alpha(roughness), eta=ior,
        conductor_eta=g(mats.conductor_eta), conductor_k=g(mats.conductor_k),
        rs_blend=g(mats.rs_blend), dist=dist, used=mats.used_lobes,
    )
    return bsdf, it
