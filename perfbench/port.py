"""The benchmark's one door into the program: its scene, configuration and
renderer entry points, the ``Intersector`` wrapper of the traced run, and
the program's kernel library.  Nothing else under ``perfbench/`` imports
``mcrt_tpu_torch``."""
from __future__ import annotations

from torch.profiler import record_function

from . import scenes


def scene(spec, device):
    """The program's (Scene, camera) from a ``SceneSpec``."""
    from mcrt_tpu_torch.camera import pinhole
    from mcrt_tpu_torch.scene import scene as scene_mod, textures

    return scenes.assemble(spec, scene_mod, textures, pinhole, device)


def render_config(render: dict):
    from mcrt_tpu_torch.config import from_dict

    return from_dict(render)


def renderer(spec, render: dict, device):
    from mcrt_tpu_torch.renderer import Renderer

    sc, cam = scene(spec, device)
    return Renderer(sc, cam, render_config(render), device=device)


def spanned_intersector(base, masks: dict):
    """``base`` with each query in a ``record_function`` span
    (``perfbench.query.intersect`` / ``.occluded``), and the ``active`` mask
    it was handed kept in ``masks`` by kind (read after the window, so the
    count adds no op to it): the ray-counting pattern of the port's chip
    smoke test."""
    from mcrt_tpu_torch.accel import Intersector

    def wrap(fn, kind):
        def run(s, r):
            masks.setdefault(kind, []).append(r.active)
            with record_function(f"perfbench.query.{kind}"):
                return fn(s, r)
        return run

    return Intersector(wrap(base.intersect, "intersect"), wrap(base.occluded, "occluded"),
                       base.accel)
