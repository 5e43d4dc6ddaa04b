"""The reference side of a check: the plain reference's scene, queries and
samples from the same ``SceneSpec`` the program was given.  It imports
nothing of the program.

``Reference("bfloat16")`` is the control: the same reference with every
floating-point result of every op rounded to bfloat16, the precision
below the float32 that the configurations state.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from . import scenes
from .reference import config as ref_config
from .reference import gradients as ref_grad
from .reference import render as ref_render
from .reference.camera import pinhole
from .reference.query import ClusterQuery
from .reference.scene import scene as scene_mod, textures


class RoundTo(TorchDispatchMode):
    """Rounds every float32 output of every op to ``dtype`` and back: the
    computation carried in ``dtype``, its tensors stored as float32."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))

        def rnd(x):
            if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                return x.to(self.dtype).to(torch.float32)
            return x
        return tree_map(rnd, out)


class Reference:
    """The reference's answers for a check, built anew from the spec at each
    call; ``precision`` names the dtype every op's result is rounded to
    (the control), or None for float32."""

    def __init__(self, precision: str | None = None):
        self.precision = precision

    def _run(self, fn, spec, render, device, *args):
        sc, cam = scenes.assemble(spec, scene_mod, textures, pinhole, device)
        query = ClusterQuery(spec.positions, spec.indices, spec.face_shape, device)
        cfg = ref_config.from_dict(render)
        with torch.no_grad():
            if self.precision is None:
                return fn(sc, cam, cfg, *args, query)
            with RoundTo(getattr(torch, self.precision)):
                return fn(sc, cam, cfg, *args, query)

    def film(self, spec, render: dict, pixels, frames):
        """(P, 3) progressive film at ``pixels`` after samples ``frames``."""
        return self._run(ref_render.film_at, spec, render, pixels.device, pixels, frames)

    def mean(self, spec, render: dict, pixels, frames):
        """(P, 3) mean radiance at ``pixels`` over samples ``frames``."""
        return self._run(ref_render.mean_at, spec, render, pixels.device, pixels, frames)

    def train(self, spec, render: dict, frames, target_frame: int, lr: float, device):
        """(losses, first gradient, parameter change) of the first steps of
        inverse rendering from the scene's parameters, one sample a step."""
        def fn(sc, cam, cfg, query):
            return ref_grad.first_steps(sc, cam, cfg, query, frames, target_frame, lr)
        return self._run(fn, spec, render, device)
