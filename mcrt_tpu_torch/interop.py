"""Build port objects from another package's tables given as numpy arrays.

The JAX package is the port's reference.  These helpers take its scene,
camera and blocked-accel tables as plain numpy arrays (no jax import here),
so that a test can run both packages on identical inputs: the counterpart
of carrying weights across.

``scene_from_numpy`` takes a flat dict keyed by dotted field paths of the
reference's ``Scene`` (``"geometry.positions"``, ``"materials.diffuse"``,
``"lights.tri_cdf"``, ``"center"``, ...).  Texture tables, if present, are
only counted: a scene with textures is refused at shading.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.blocked import BlockedAccel
from .camera.pinhole import PinholeCamera
from .scene.scene import (Geometry, Lights, Materials, Scene, Shapes,
                          TextureAtlas)

_GEOMETRY_DTYPES = {
    "positions": torch.float32, "normals": torch.float32,
    "uvs": torch.float32, "indices": torch.int32, "face_shape": torch.int32,
    "face_valid": torch.bool, "face_attrs": torch.float32,
}
_SHAPE_DTYPES = {"material": torch.int32, "light": torch.int32,
                 "to_world": torch.float32, "normal_mat": torch.float32}
_MATERIAL_FIELDS = ("diffuse", "glossy", "kr", "kt", "opacity", "roughness",
                    "ior", "tex", "conductor_eta", "conductor_k", "rs_blend")
_LIGHT_FIELDS = ("type", "position", "direction", "intensity", "radius",
                 "area", "shape", "tri_offset", "tri_count", "tri_index",
                 "tri_cdf", "tri_light", "num")


def _group(leaves: dict, prefix: str, names) -> dict:
    return {k: np.array(leaves[f"{prefix}.{k}"]) for k in names}


def scene_from_numpy(leaves: dict[str, np.ndarray], device="cpu") -> Scene:
    """A port ``Scene`` from the reference scene's leaves (see module doc)."""
    if any(k.startswith("instances.") for k in leaves):
        raise NotImplementedError("instanced scenes are not ported yet (ROADMAP)")

    def t(key, dtype):
        return torch.as_tensor(np.array(leaves[key]), dtype=dtype, device=device)

    geometry = Geometry(**{k: t(f"geometry.{k}", d)
                           for k, d in _GEOMETRY_DTYPES.items()})
    shapes = Shapes(**{k: t(f"shapes.{k}", d) for k, d in _SHAPE_DTYPES.items()})
    offset = leaves.get("textures.offset")
    return Scene(
        geometry=geometry,
        shapes=shapes,
        materials=Materials.from_arrays(
            device, **_group(leaves, "materials", _MATERIAL_FIELDS)),
        lights=Lights.from_arrays(device, **_group(leaves, "lights", _LIGHT_FIELDS)),
        textures=TextureAtlas(num=0 if offset is None else int(np.asarray(offset).shape[1])),
        center=t("center", torch.float32),
        radius=t("radius", torch.float32),
    )


def camera_from_numpy(leaves: dict[str, np.ndarray], device="cpu") -> PinholeCamera:
    """A port ``PinholeCamera`` from the reference camera's fields."""
    return PinholeCamera(**{
        k: torch.as_tensor(np.array(v), dtype=torch.float32, device=device)
        for k, v in leaves.items()})


def blocked_accel_from_numpy(tri, aabb, slot_prim, bounds, chunk_aabb,
                             num_blocks: int, device="cpu",
                             builder: str = "sah") -> BlockedAccel:
    """A port ``BlockedAccel`` from the reference's blocked-accel tables."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return BlockedAccel(
        tri=t(tri, torch.float32), aabb=t(aabb, torch.float32),
        slot_prim=t(slot_prim, torch.int32), bounds=t(bounds, torch.float32),
        chunk_aabb=t(chunk_aabb, torch.float32), num_blocks=int(num_blocks),
        builder=builder,
    )
