"""Material dispatch (counterpart of ``mcrt_tpu/bsdf/materials.py``):
per-hit uber-material property fetch.

Texture modulation and the normal map need texture sampling, which is not
ported yet (ROADMAP): ``fetch_bsdf`` refuses a scene with textures."""
from __future__ import annotations

import torch

from ..core.types import Interaction
from ..scene.scene import Scene, take_clip
from . import bxdfs as bx
from .uber import UberBSDF


def fetch_bsdf(scene: Scene, it: Interaction,
               dist: int = bx.TROWBRIDGE_REITZ) -> tuple[UberBSDF, Interaction]:
    """Gather material parameters at each interaction.  Returns (bsdf,
    interaction); the interaction's frame is unchanged without normal maps."""
    if scene.textures.num > 0:
        raise NotImplementedError(
            "textured scenes are not ported yet (ROADMAP, Queue 1: textures)")
    mats = scene.materials
    mid = it.material.clamp_min(0)

    def g(arr):
        return take_clip(arr, mid)

    bsdf = UberBSDF(
        diffuse=g(mats.diffuse), glossy=g(mats.glossy), kr=g(mats.kr),
        kt=g(mats.kt),
        passthrough=torch.clamp(1.0 - g(mats.opacity), 0.0, 1.0),
        alpha=bx.roughness_to_alpha(g(mats.roughness)), eta=g(mats.ior),
        conductor_eta=g(mats.conductor_eta), conductor_k=g(mats.conductor_k),
        rs_blend=g(mats.rs_blend), dist=dist, used=mats.used_lobes,
    )
    return bsdf, it
