"""The reference's inverse-rendering steps: the mean squared error of a
whole rendered frame against a target frame, differentiated with respect to
every material's diffuse albedo and roughness and every light's intensity
(the port's ``full_params``, frozen below), and a plain Adam update with
``torch.optim.Adam``'s formula."""
from __future__ import annotations

import torch

from .core import math as m
from .render import render_lanes


def full_params_get(scene) -> dict:
    return {"diffuse": scene.materials.diffuse, "roughness": scene.materials.roughness,
            "intensity": scene.lights.intensity}


def full_params_set(scene, p: dict):
    """The scene with ``p``, clipped as the port's parameter views clip."""
    mats = scene.materials.replace(diffuse=m.fclip(p["diffuse"], 0.0, 1.0),
                                   roughness=m.fclip(p["roughness"], 1e-3, 1.0))
    return scene.replace(materials=mats,
                         lights=scene.lights.replace(intensity=m.fmax(p["intensity"], 0.0)))


def frame(scene, camera, cfg, f: int, query) -> torch.Tensor:
    """(H*W, 3) radiance of sample ``f`` of every pixel, row-major."""
    n = cfg.width * cfg.height
    pix = torch.arange(n, device=camera.position.device)
    return render_lanes(scene, camera, cfg, pix, torch.full_like(pix, int(f)), query)


class Adam:
    """Adam over a dict of leaves, as ``torch.optim.Adam`` computes a step:
    p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, betas[0], betas[1], eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
            denom = self.v[k].sqrt() / (bc2 ** 0.5) + self.eps
            out[k] = p - (self.lr / bc1) * self.m[k] / denom
        return out


def first_steps(scene, camera, cfg, query, frames, target_frame: int, lr: float):
    """(losses, first gradient, parameter change) of ``len(frames)`` steps
    from the scene's own parameters, one sample a step, against the target
    sample ``target_frame``."""
    with torch.no_grad():
        target = frame(scene, camera, cfg, target_frame, query)
    params = {k: v.detach().clone() for k, v in full_params_get(scene).items()}
    start = {k: v.clone() for k, v in params.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for f in frames:
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            img = frame(full_params_set(scene, leaves), camera, cfg, f, query)
            loss = torch.mean((img - target) ** 2)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                         allow_unused=True)))
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params = opt.step({k: v.detach() for k, v in params.items()}, grads)
    return losses, first, {k: params[k] - start[k] for k in params}
