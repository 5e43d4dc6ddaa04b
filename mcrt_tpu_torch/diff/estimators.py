"""Differentiable-rendering estimators and parameter plumbing (counterpart
of ``mcrt_tpu/diff/estimators.py``).

Both integrators, the path tracer and BDPT, are differentiated end to end
on torch autograd with respect to material, light, light-geometry and
texel parameters; ``render_loss_fn``, ``InverseRenderer`` and
``make_train_step`` take either.  The estimators are the JAX package's:

- **BSDF sampling** is detached: the sampled direction and pdf carry no
  gradient, the BSDF value ``f`` does (``bsdf.uber.sample``);
- **NEE** is reparameterized: the light sample point moves with the light's
  parameters, and the d^2/(cos A) pdf is differentiated through;
- **visibility and intersection** are discrete events: the queries detach
  their ray table (``accel.blocked``, ``accel.two_level``), so no kernel
  has, or needs, a backward.

Parameter setters clip with ``core.math.fclip``/``fmax``, whose gradient at
a tie with the bound is the JAX package's (half), because the defaults sit
on the bounds: roughness 1.0, black diffuse, opaque texels.
``InverseRenderer`` runs ``torch.optim.Adam`` with optax's defaults in place
of ``optax.adam``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..accel import build_intersector
from ..core import math as m
from ..parallel.render import render_spp_batch
from ..utils.profiling import span


class ParamView(NamedTuple):
    """A differentiable view over a subset of scene parameters."""

    get: Callable[[Any], dict]
    set: Callable[[Any, dict], Any]


def material_params() -> ParamView:
    """Albedo + roughness of every material."""
    return ParamView(
        get=lambda s: {"diffuse": s.materials.diffuse,
                       "roughness": s.materials.roughness},
        set=lambda s, p: s.replace(materials=s.materials.replace(
            diffuse=m.fclip(p["diffuse"], 0.0, 1.0),
            roughness=m.fclip(p["roughness"], 1e-3, 1.0))),
    )


def light_params() -> ParamView:
    """Intensity of every light."""
    return ParamView(
        get=lambda s: {"intensity": s.lights.intensity},
        set=lambda s, p: s.replace(lights=s.lights.replace(
            intensity=m.fmax(p["intensity"], 0.0))),
    )


def full_params() -> ParamView:
    """Materials and light intensities."""
    mv, lv = material_params(), light_params()
    return ParamView(get=lambda s: {**mv.get(s), **lv.get(s)},
                     set=lambda s, p: lv.set(mv.set(s, p), p))


def light_geometry_params() -> ParamView:
    """Light position + direction (point, directional and disk lights).
    The sampled light point moves with these parameters, so gradients flow
    through Li = I/d^2, the area pdf and the sampled direction; visibility
    stays a detached discrete event."""

    def _set(s, p):
        d = p["direction"]
        d = d / m.fmax(torch.linalg.vector_norm(d, dim=-1, keepdim=True), 1e-12)
        return s.replace(lights=s.lights.replace(position=p["position"], direction=d))

    return ParamView(get=lambda s: {"position": s.lights.position,
                                    "direction": s.lights.direction},
                     set=_set)


def with_float_texels(scene):
    """The scene with the float texel atlas ``data_f`` made from the u8
    texels (prerequisite for ``texture_params``)."""
    tex = scene.textures
    if tex.num == 0 or tex.data_f is not None:
        return scene
    return scene.replace(textures=tex.replace(data_f=tex.data.to(torch.float32) / 255.0))


def texture_params() -> ParamView:
    """Every texel of the atlas (all textures and their mip chains; the mip
    levels optimize independently).  Bilinear and trilinear filtering are
    linear in the texels, so a gradient spreads over the footprint's
    corners with the filter weights.  Call ``with_float_texels`` first."""
    return ParamView(
        get=lambda s: {"texels": s.textures.data_f},
        set=lambda s, p: s.replace(textures=s.textures.replace(
            data_f=m.fclip(p["texels"], 0.0, 1.0))),
    )


def render_loss_fn(camera, cfg, intersector, view: ParamView, mesh=None):
    """``loss(params, scene, frames, target)``: the mean squared error of
    the rendered (H*W, 3) image against ``target``."""

    def loss(params, scene, frames, target):
        with span("mcrt.loss"):
            img = render_spp_batch(view.set(scene, params), camera, frames, cfg,
                                   intersector, mesh)
            return torch.mean((img - target.reshape(img.shape)) ** 2)

    return loss


class InverseRenderer:
    """Adam-based inverse renderer: optimizes scene parameters to match a
    target image (BASELINE configuration 5).  The scene and camera stay on
    their device; the parameters are leaf tensors there."""

    def __init__(self, scene, camera, cfg, view: ParamView | None = None,
                 learning_rate: float = 5e-2, mesh=None):
        self.scene = scene
        self.cfg = cfg
        self.view = view or material_params()
        self.learning_rate = learning_rate
        self.intersector = build_intersector(scene, cfg)
        self.loss_fn = render_loss_fn(camera, cfg, self.intersector, self.view, mesh)

    def run(self, target: torch.Tensor, steps: int = 100, spp_per_step: int = 4,
            seed: int = 1234, advance_frames: bool = True, callback=None):
        """Returns ``(scene with the clipped parameters, params, losses)``.
        ``advance_frames=False`` reuses the same sample streams every step:
        a deterministic optimization, without Monte Carlo gradient noise
        when the target was rendered with the same streams."""
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in self.view.get(self.scene).items()}
        opt = torch.optim.Adam(list(params.values()), lr=self.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        losses = []
        with torch.enable_grad():
            for i in range(steps):
                off = seed + i * spp_per_step if advance_frames else seed
                frames = range(off, off + spp_per_step)
                opt.zero_grad(set_to_none=True)
                loss = self.loss_fn(params, self.scene, frames, target)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
                if callback is not None:
                    callback(i, params, losses[-1])
        with torch.no_grad():
            scene = self.view.set(self.scene, {k: v.detach() for k, v in params.items()})
        return scene, params, losses
