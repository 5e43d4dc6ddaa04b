"""Gradients of rendered samples, compared across devices: the card's
against the CPU's on the same scene and parameters (``chip_smoke.py``'s
``[grad_parity]`` and the card tests).

The gradient compared is that of the sum of the samples' radiance over
the (sample, pixel) pairs whose forward radiance agrees on both devices
(rtol 1e-3 / atol 1e-4): a sample that differs (a 1-ulp rounding
difference between torch's CUDA and CPU kernels that flips a discrete
event, as ``textured_hall``'s texture LOD and passthrough lobe can) follows
another path on each.  At least ``MIN_AGREE`` of the pairs must agree,
the share the render parity phases ask of 1-spp images.  Each field is
then held to ``|a - b| <= rtol * |b| + atol * max|b|`` with ``GRAD_TOL``'s
(rtol, atol): the tolerance of the port against the JAX package on the
CPU (``tests/test_torch_diff.py``).  On the card the backward of a gather
is an atomic scatter-add, so its gradients differ from the CPU's in their
last bits and are never compared for equality.
"""
from __future__ import annotations

import numpy as np
import torch

MIN_AGREE = 0.99
GRAD_TOL = {"diffuse": (1e-4, 1e-5), "roughness": (1e-4, 1e-5), "intensity": (1e-4, 1e-5),
            "position": (1e-4, 1e-5), "direction": (1e-4, 1e-5), "texels": (1e-4, 1e-5)}


def sample_grads(scene, camera, cfg, intersector, view, frames, weight):
    """The gradient of ``sum(weight * radiance)`` over the samples
    ``frames`` ((S, H*W, 3) ``render_sample`` radiance, ``weight`` (S, H*W,
    1)) with respect to each field of ``view.get(scene)`` (zeros for a
    field the image does not use)."""
    from ..renderer import render_sample

    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}
    with torch.enable_grad():
        scene_p = view.set(scene, params)
        img = torch.stack([render_sample(scene_p, camera, int(f), cfg, intersector)[0]
                           for f in frames])
        grads = torch.autograd.grad((img * weight).sum(), list(params.values()),
                                    allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(params.items(), grads)}


def device_parity(builder, view_name: str, size: int, spp: int, depth: int, device,
                  float_texels: bool = False):
    """The scene of ``builder`` on ``device`` and on the CPU, and each
    device's gradient over the (sample, pixel) pairs that agree: returns
    (share of agreeing pairs, {field: (device grad on the CPU, CPU grad)})."""
    from ..accel import build_intersector
    from ..config import IntegratorConfig, RenderConfig
    from ..diff import estimators
    from ..renderer import render_sample

    cfg = RenderConfig(width=size, height=size, spp=spp,
                       integrator=IntegratorConfig(max_depth=depth))
    view = getattr(estimators, view_name)()
    runs = {}
    for dev in (device, "cpu"):
        scene, camera = builder(device=dev)
        if float_texels:
            scene = estimators.with_float_texels(scene)
        runs[dev] = (scene, camera, cfg, build_intersector(scene, cfg))
    frames = range(spp)
    with torch.no_grad():
        imgs = {dev: torch.stack([render_sample(s, c, f, g, i)[0] for f in frames]).cpu()
                for dev, (s, c, g, i) in runs.items()}
    agree = torch.isclose(imgs[device], imgs["cpu"], rtol=1e-3, atol=1e-4).all(-1)
    weight = agree.to(torch.float32)[..., None]
    grads = {dev: sample_grads(*run, view, frames, weight.to(dev))
             for dev, run in runs.items()}
    return (float(agree.float().mean()),
            {k: (grads[device][k].cpu(), grads["cpu"][k]) for k in grads["cpu"]})


def compare(grads: dict) -> dict:
    """{field: (max |a - b|, max |b|, within GRAD_TOL)} of {field: (a, b)}."""
    out = {}
    for k, (a, b) in grads.items():
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        rtol, atol = GRAD_TOL[k]
        scale = float(np.abs(b).max()) if b.size else 0.0
        err = np.abs(a - b)
        out[k] = (float(err.max()) if err.size else 0.0, scale,
                  bool(np.isfinite(a).all() and (err <= rtol * np.abs(b) + atol * scale).all()))
    return out
