"""Kernel inputs at the main path's shapes, for ``chip_smoke.py`` and
``tools/tree_ab.py``: the 512x512 primary and bounce wavefronts, and the
inputs that a kernel is handed during one frame of a ``Renderer`` or any
other call (a gradient step)."""
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


def inputs_of(run, ids) -> dict[str, list[tuple]]:
    """``run()`` with the wrappers of the kernels ``ids`` (keys of
    ``kernels.WRAPPERS``) wrapped for that call: returns, for each id, the
    arguments of every launch in it, their tensors cloned (the call frees
    them).  The wrapper only keeps the arguments and calls the kernel's own
    wrapper, which launches and counts as always; the queries look their
    wrappers up in ``kernels`` at each call, so every launch is seen."""
    from ..accel import kernels

    kept = {k: [] for k in ids}
    own = {k: kernels.WRAPPERS[k] for k in ids}

    def keeping(k):
        def keep(*args):
            kept[k].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                 for a in args))
            return own[k](*args)
        # a wrapper counts its launches on the name it has in ``kernels``:
        # the keeper carries the count for the frame and hands it back
        keep.launches = own[k].launches
        return keep

    for k, fn in own.items():
        setattr(kernels, fn.__name__, keeping(k))
    try:
        run()
    finally:
        for fn in own.values():
            fn.launches = getattr(kernels, fn.__name__).launches
            setattr(kernels, fn.__name__, fn)
    return kept
