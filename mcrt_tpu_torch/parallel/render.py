"""Batches of samples, the gradient step, and both sharded over a device
mesh (counterpart of ``mcrt_tpu/parallel/render.py``).

``render_spp_batch`` renders several samples per pixel of the full image
and returns their mean.  On one device the JAX package scans
``render_sample`` over the frames (``lax.map``); the port loops over them
eagerly, each sample at the unbatched wavefront shapes the kernels are
built for.  It is differentiable: under autograd the mean carries the
graph of every sample, so ``make_train_step`` differentiates an image loss
with respect to scene parameters (inverse rendering's step).

With a mesh (``parallel/mesh.py``) the (S, N) sample-by-pixel grid is
split over the (spp, rays) axes, as the JAX package's GSPMD sharding
splits it: each rank renders its S / n_spp frames, and (with a replicated
intersector) only its N / n_rays Morton-ordered trace slots; the spp mean
is an ``all_reduce`` over the spp group and the image an ``all_gather``
over the rays group, so every rank returns the full (N, 3) mean.  Under
the ray ring (``parallel/ring.py``) the ring owns the rays axis: each rank
traces every pixel and the ring splits each query's rays.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..renderer import SlotSlice, render_sample, slot_pixels
from .mesh import RAYS_AXIS, SPP_AXIS, axis_size, check_mesh, rays_share, spp_share


def _ring_owns_rays(intersector) -> bool:
    from .ring import ShardedBlockedAccel

    return isinstance(intersector.accel, ShardedBlockedAccel)


def _sliced(mesh, intersector) -> bool:
    """Whether each rank traces only its slice of the trace slots: a rays
    axis of more than one rank and a replicated intersector."""
    return axis_size(mesh, RAYS_AXIS) > 1 and not _ring_owns_rays(intersector)


class _GroupSum(torch.autograd.Function):
    """The sum of a tensor over a process group (an ``all_reduce``), with
    a backward: each rank's input reaches every rank's sum, so its
    cotangent is the sum of every rank's cotangent, the same
    ``all_reduce``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _local_part(scene, camera, frames, cfg, intersector, mesh):
    """This rank's share of the sharded mean: (the mean of its frames over
    its lanes, with autograd's graph where it is on; the pixel of each lane
    (a long tensor), or None where the rank traced the whole image in
    row-major order)."""
    share = pix = None
    if _sliced(mesh, intersector):
        group = mesh.get_group(RAYS_AXIS)
        share = SlotSlice(*rays_share(mesh, cfg.width * cfg.height),
                          lambda film: _GroupSum.apply(film, group))
        pix = slot_pixels(cfg.width, cfg.height, camera.position.device, share.lo, share.hi)
    out = torch.stack([render_sample(scene, camera, f, cfg, intersector, share)[0]
                       for f in spp_share(mesh, frames)])
    return out.mean(0), pix


def _assemble(part: torch.Tensor, pix, mesh, cfg) -> torch.Tensor:
    """The full (N, 3) mean from every rank's ``_local_part`` (detached):
    the spp mean over the spp group, then the lanes of the rays group."""
    img = part.detach().clone()
    dist.all_reduce(img, group=mesh.get_group(SPP_AXIS))
    img = img / axis_size(mesh, SPP_AXIS)
    if pix is None:
        return img
    pieces = [torch.empty_like(img) for _ in range(axis_size(mesh, RAYS_AXIS))]
    dist.all_gather(pieces, img, group=mesh.get_group(RAYS_AXIS))
    out = torch.empty((cfg.width * cfg.height, 3), dtype=img.dtype, device=img.device)
    out[slot_pixels(cfg.width, cfg.height, img.device)] = torch.cat(pieces)
    return out


def render_spp_batch(scene, camera, frames, cfg, intersector, mesh=None) -> torch.Tensor:
    """(H*W, 3) mean radiance of the samples ``frames`` (host sample
    indices: a sequence of ints, a numpy array or a CPU tensor), in
    row-major pixel order: the mean over the (S, H*W, 3) stack of
    ``render_sample`` outputs.  With ``mesh`` every rank calls it with the
    same arguments and gets the full mean; S must divide over the spp
    axis and H*W over the rays axis.  The sharded mean carries no graph:
    differentiate through ``make_train_step``."""
    if mesh is None:
        out = torch.stack([render_sample(scene, camera, int(f), cfg, intersector)[0]
                           for f in frames])
        return out.mean(0)
    check_mesh(mesh)
    part, pix = _local_part(scene, camera, frames, cfg, intersector, mesh)
    return _assemble(part, pix, mesh, cfg)


def make_sharded_render(scene, camera, cfg, intersector, mesh
                        ) -> Callable[[Any, Any], torch.Tensor]:
    """``fn(scene, frames) -> (H*W, 3)``: ``render_spp_batch`` over ``mesh``
    under ``torch.no_grad()``.  The scene is an argument, so an edited
    scene renders without a new function."""
    check_mesh(mesh)

    def fn(scene_in, frames) -> torch.Tensor:
        with torch.no_grad():
            return render_spp_batch(scene_in, camera, frames, cfg, intersector, mesh)

    return fn


def make_train_step(camera, cfg, intersector, mesh,
                    param_get: Callable[[Any], dict],
                    param_set: Callable[[Any, dict], Any]):
    """Inverse-rendering step: the mean squared image error differentiated
    with respect to scene parameters.

    Returns ``step(scene, frames, target) -> (loss, grads)``: ``loss`` a
    0-d tensor, ``grads`` a dict shaped like ``param_get(scene)``, the
    gradient at the parameters ``scene`` holds.

    With ``mesh`` every rank calls ``step`` with the same arguments and
    gets the same loss and gradients.  The loss is not linear in the
    samples, so no rank can differentiate the error of its own partial
    image: the ranks assemble the image without a graph, autograd gives the
    loss's cotangent at it, and each rank backpropagates that cotangent
    (over its own lanes, divided by n_spp) through its partial mean; the
    parameter gradients are then summed over both axes."""
    if mesh is not None:
        check_mesh(mesh)

    def step(scene, frames, target: torch.Tensor):
        params = {k: v.detach().requires_grad_() for k, v in param_get(scene).items()}
        leaves = list(params.values())
        with torch.enable_grad():
            scene_p = param_set(scene, params)
            if mesh is None:
                img = render_spp_batch(scene_p, camera, frames, cfg, intersector)
                loss = torch.mean((img - target.reshape(img.shape)) ** 2)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            else:
                loss, grads = _sharded_grads(scene_p, camera, frames, cfg, intersector,
                                             mesh, target, leaves)
        return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                               for (k, v), g in zip(params.items(), grads)}

    return step


def _sharded_grads(scene, camera, frames, cfg, intersector, mesh, target, leaves):
    """(loss, gradients summed over the mesh) of the sharded step."""
    part, pix = _local_part(scene, camera, frames, cfg, intersector, mesh)
    img = _assemble(part, pix, mesh, cfg).requires_grad_()
    loss = torch.mean((img - target.reshape(img.shape)) ** 2)
    (g_img,) = torch.autograd.grad(loss, img)
    g_img = g_img / axis_size(mesh, SPP_AXIS)
    if pix is not None:
        g_part = g_img[pix]
    elif axis_size(mesh, RAYS_AXIS) > 1:
        # the ring: every rank traced every pixel; each backpropagates only
        # its own range of them
        lo, hi = rays_share(mesh, g_img.shape[0])
        g_part = torch.zeros_like(g_img)
        g_part[lo:hi] = g_img[lo:hi]
    else:
        g_part = g_img
    grads = list(torch.autograd.grad(part, leaves, grad_outputs=g_part, allow_unused=True))
    for i, g in enumerate(grads):
        g = torch.zeros_like(leaves[i]) if g is None else g.contiguous()
        for axis in (SPP_AXIS, RAYS_AXIS):
            dist.all_reduce(g, group=mesh.get_group(axis))
        grads[i] = g
    return loss.detach(), grads
