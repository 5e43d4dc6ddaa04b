"""Frozen numpy scene generators, one module a scene, found by the name a
configuration gives under ``"scene"``.  Each module's ``build(**args)``
returns a ``SceneSpec`` (``_geometry.py``): host arrays that the harness
hands to the program's scene API and to the reference alike."""
from __future__ import annotations

import importlib


def load(name: str, args: dict | None = None):
    """The ``SceneSpec`` of the generator module ``name`` with ``args``."""
    return importlib.import_module(f"{__name__}.{name}").build(**(args or {}))


def assemble(spec, scene_mod, tex_mod, cam_mod, device):
    """(Scene, camera) from ``spec`` through a scene API: the program's
    modules (``scene.scene``, ``scene.textures``, ``camera.pinhole``) or the
    reference's copies of them, which take the same calls."""
    atlas = None
    if spec.textures:
        builder = tex_mod.AtlasBuilder()
        for image, wrap in spec.textures:
            builder.add(image, wrap)
        atlas = builder.build()
    lights = scene_mod.make_lights(spec.lights, spec.positions, spec.indices,
                                   spec.face_shape, device=device)
    scene = scene_mod.build_scene(
        spec.positions, spec.normals, spec.uvs, spec.indices, spec.face_shape,
        spec.shape_material, [scene_mod.UberMaterial(**m) for m in spec.materials],
        lights=lights, shape_light=spec.shape_light, textures=atlas, device=device)
    return scene, cam_mod.PinholeCamera.look_at(**spec.camera, device=device)
