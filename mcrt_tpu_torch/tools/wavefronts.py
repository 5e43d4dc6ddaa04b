"""Kernel inputs at the main path's shapes, for ``chip_smoke.py`` and
``tools/tree_ab.py``: the 512x512 primary and bounce wavefronts, and the
inputs that K1 is handed during one frame of a ``Renderer``."""
from __future__ import annotations

import torch

WIDTH = HEIGHT = 512


def wavefronts(camera, intersect, device, width: int = WIDTH, height: int = HEIGHT):
    """A ``width`` x ``height`` wavefront of primary rays (Morton pixel
    order, as the renderer traces them) and one of random bounce rays
    leaving the primary hits in uniformly random directions, with segments
    of 0.5 to 5 (seeded, so every call gives the same rays)."""
    from ..camera.pinhole import pixel_uv
    from ..core.types import Rays
    from ..renderer import morton_pixel_order

    order, _ = morton_pixel_order(width, height)
    uv = pixel_uv(width, height, device=device)[torch.as_tensor(order, device=device).long()]
    o, d = camera.generate_rays(uv)
    primary = Rays.make(o.contiguous(), d)
    hit = intersect(primary)
    g = torch.Generator(device=device)
    g.manual_seed(1234)
    n = primary.n
    dirs = torch.randn((n, 3), generator=g, device=device)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    p = primary.at(torch.where(hit.valid, hit.t, 0.0)) + dirs * 1e-3
    seg = 0.5 + 4.5 * torch.rand((n,), generator=g, device=device)
    bounce = Rays.make(p, dirs, tmax=seg, active=hit.valid)
    return {"primary": primary, "bounce": bounce}


def cull_inputs_of_a_frame(renderer) -> list[tuple]:
    """``renderer.step(1)`` with the queries' choice of K1 wrapped for that
    frame: returns the (rays_packed, chunk_aabb, aabb, tile) of every K1
    launch in it, the ray tables cloned (the frame frees them).  The
    wrapper only keeps the inputs and calls ``kernels.cull``, which
    launches and counts as always."""
    from ..accel import blocked, kernels, two_level

    kept, choose = [], blocked._kernel_or_plain

    def keep(rays_packed, chunk_aabb, aabb, tile):
        kept.append((rays_packed.clone(), chunk_aabb, aabb, tile))
        return kernels.cull(rays_packed, chunk_aabb, aabb, tile)

    def choose_keep(rays_packed, kernel, plain):
        chosen = choose(rays_packed, kernel, plain)
        return keep if chosen is kernels.cull else chosen

    blocked._kernel_or_plain = two_level._kernel_or_plain = choose_keep
    try:
        renderer.step(1)
    finally:
        blocked._kernel_or_plain = two_level._kernel_or_plain = choose
    return kept
