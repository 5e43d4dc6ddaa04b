"""Batches of samples and the gradient step (counterpart of
``mcrt_tpu/parallel/render.py``).

``render_spp_batch`` renders several samples per pixel of the full image
and returns their mean, on one device.  The JAX package scans
``render_sample`` over the frames (``lax.map``); the port loops over them
eagerly, each sample at the unbatched wavefront shapes the kernels are
built for.  It is differentiable: under autograd the mean carries the
graph of every sample, so ``make_train_step`` differentiates an image loss
with respect to scene parameters (inverse rendering's step).  The sharded
render and the sharded step wait for the multi-GPU item of the roadmap.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..renderer import render_sample

_NO_MESH = ("sharded rendering over a device mesh is not ported yet (ROADMAP, "
            "Queue 1: multi-GPU)")


def render_spp_batch(scene, camera, frames, cfg, intersector, mesh=None) -> torch.Tensor:
    """(H*W, 3) mean radiance of the samples ``frames`` (host sample
    indices: a sequence of ints, a numpy array or a CPU tensor), in
    row-major pixel order: the mean over the (S, H*W, 3) stack of
    ``render_sample`` outputs."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    out = torch.stack([render_sample(scene, camera, int(f), cfg, intersector)[0]
                       for f in frames])
    return out.mean(0)


def make_train_step(camera, cfg, intersector, mesh,
                    param_get: Callable[[Any], dict],
                    param_set: Callable[[Any, dict], Any]):
    """Inverse-rendering step: the mean squared image error differentiated
    with respect to scene parameters.

    Returns ``step(scene, frames, target) -> (loss, grads)``: ``loss`` a
    0-d tensor, ``grads`` a dict shaped like ``param_get(scene)``, the
    gradient at the parameters ``scene`` holds."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)

    def step(scene, frames, target: torch.Tensor):
        params = {k: v.detach().requires_grad_() for k, v in param_get(scene).items()}
        with torch.enable_grad():
            img = render_spp_batch(param_set(scene, params), camera, frames, cfg,
                                   intersector)
            loss = torch.mean((img - target.reshape(img.shape)) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                               for (k, v), g in zip(params.items(), grads)}

    return step
