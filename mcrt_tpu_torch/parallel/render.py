"""Batches of samples (counterpart of ``mcrt_tpu/parallel/render.py``).

``render_spp_batch`` renders several samples per pixel of the full image
and returns their mean, on one device.  The JAX package scans
``render_sample`` over the frames (``lax.map``); the port loops over them
eagerly, each sample at the unbatched wavefront shapes the kernels are
built for.  The sharded render and the training step wait for the
multi-GPU and inverse-rendering items of the roadmap.
"""
from __future__ import annotations

import torch

from ..renderer import render_sample


def render_spp_batch(scene, camera, frames, cfg, intersector, mesh=None) -> torch.Tensor:
    """(H*W, 3) mean radiance of the samples ``frames`` (host sample
    indices: a sequence of ints, a numpy array or a CPU tensor), in
    row-major pixel order: the mean over the (S, H*W, 3) stack of
    ``render_sample`` outputs."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded rendering over a device mesh is not ported yet (ROADMAP, "
            "Queue 1: multi-GPU)")
    out = torch.stack([render_sample(scene, camera, int(f), cfg, intersector)[0]
                       for f in frames])
    return out.mean(0)
