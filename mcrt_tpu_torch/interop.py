"""Build port objects from another package's tables given as numpy arrays.

The JAX package is the port's reference.  These helpers take its scene,
camera and accel tables as plain numpy arrays (no jax import here), so
that a test can run both packages on identical inputs: the counterpart of
carrying weights across.  Like every entry point of the port, they put
what they build on the CUDA card unless the caller names another
``device``.

``scene_from_numpy`` takes a flat dict keyed by dotted field paths of the
reference's ``Scene`` (``"geometry.positions"``, ``"materials.diffuse"``,
``"lights.tri_cdf"``, ``"textures.data"``, ``"textures.data_f"``,
``"instances.shape"``, ``"center"``, ...).  The instance registry's face
ranges are static fields of the reference, not array leaves: pass them as
``"instances.face_lo"`` and ``"instances.face_hi"`` beside its arrays.
``params_from_numpy`` makes the leaf parameter tensors of inverse
rendering from the same arrays the reference starts from.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.blocked import BlockedAccel
from .accel.lbvh import LBVH
from .accel.two_level import TwoLevelAccel
from .camera.pinhole import PinholeCamera
from .core.types import default_device
from .scene.scene import (Geometry, Instances, Lights, Materials, Scene, Shapes,
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
_TEXTURE_DTYPES = {"data": torch.uint8, "offset": torch.int32, "width": torch.int32,
                   "height": torch.int32, "mips": torch.int32, "wrap": torch.int32}


def _group(leaves: dict, prefix: str, names) -> dict:
    return {k: np.array(leaves[f"{prefix}.{k}"]) for k in names}


def scene_from_numpy(leaves: dict[str, np.ndarray], device=None) -> Scene:
    """A port ``Scene`` from the reference scene's leaves (see module doc)."""
    device = default_device(device)

    def t(key, dtype):
        return torch.as_tensor(np.array(leaves[key]), dtype=dtype, device=device)

    instances = None
    if "instances.shape" in leaves:
        instances = Instances(
            shape=t("instances.shape", torch.int32),
            src_shape=t("instances.src_shape", torch.int32),
            face_lo=tuple(int(x) for x in leaves["instances.face_lo"]),
            face_hi=tuple(int(x) for x in leaves["instances.face_hi"]))
    geometry = Geometry(**{k: t(f"geometry.{k}", d) for k, d in _GEOMETRY_DTYPES.items()},
                        instanced=instances is not None)
    shapes = Shapes(**{k: t(f"shapes.{k}", d) for k, d in _SHAPE_DTYPES.items()})
    textures = (TextureAtlas(**{k: t(f"textures.{k}", d) for k, d in _TEXTURE_DTYPES.items()},
                             data_f=(t("textures.data_f", torch.float32)
                                     if "textures.data_f" in leaves else None))
                if "textures.data" in leaves else TextureAtlas.empty(device))
    return Scene(
        geometry=geometry,
        shapes=shapes,
        materials=Materials.from_arrays(
            device, **_group(leaves, "materials", _MATERIAL_FIELDS)),
        lights=Lights.from_arrays(device, **_group(leaves, "lights", _LIGHT_FIELDS)),
        textures=textures,
        center=t("center", torch.float32),
        radius=t("radius", torch.float32),
        instances=instances,
    )


def params_from_numpy(params: dict[str, np.ndarray], device=None) -> dict[str, torch.Tensor]:
    """Leaf float32 tensors that require grad, one per array: the starting
    parameters of ``diff.estimators`` views and optimizers."""
    device = default_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device,
                            requires_grad=True) for k, v in params.items()}


def camera_from_numpy(leaves: dict[str, np.ndarray], device=None) -> PinholeCamera:
    """A port ``PinholeCamera`` from the reference camera's fields."""
    device = default_device(device)
    return PinholeCamera(**{
        k: torch.as_tensor(np.array(v), dtype=torch.float32, device=device)
        for k, v in leaves.items()})


def blocked_accel_from_numpy(tri, aabb, slot_prim, bounds, chunk_aabb,
                             num_blocks: int, device=None,
                             builder: str = "sah") -> BlockedAccel:
    """A port ``BlockedAccel`` from the reference's blocked-accel tables."""
    device = default_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return BlockedAccel(
        tri=t(tri, torch.float32), aabb=t(aabb, torch.float32),
        slot_prim=t(slot_prim, torch.int32), bounds=t(bounds, torch.float32),
        chunk_aabb=t(chunk_aabb, torch.float32), num_blocks=int(num_blocks),
        builder=builder,
    )


def two_level_accel_from_numpy(blas: BlockedAccel, world_to_object, tw_rows, shape_id,
                               pair_aabb, pair_chunk, pair_code, bounds,
                               num_instances: int, num_pairs: int,
                               device=None) -> TwoLevelAccel:
    """A port ``TwoLevelAccel`` from the reference's two-level tables, with
    its BLAS from ``blocked_accel_from_numpy``."""
    device = default_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return TwoLevelAccel(
        blas=blas.to(device), world_to_object=t(world_to_object, torch.float32),
        tw_rows=t(tw_rows, torch.float32), shape_id=t(shape_id, torch.int32),
        pair_aabb=t(pair_aabb, torch.float32), pair_chunk=t(pair_chunk, torch.float32),
        pair_code=t(pair_code, torch.int32), bounds=t(bounds, torch.float32),
        num_instances=int(num_instances), num_pairs=int(num_pairs))


def lbvh_from_numpy(node_min, node_max, left, right, prim, prim_valid, packed_t, children,
                    leaf_t, unified_t=None, unified_ci=None, leaf_size: int = 2,
                    device=None) -> LBVH:
    """A port ``LBVH`` from the reference's LBVH arrays, its component-major
    traversal tables stored row-major as the port keeps them."""
    device = default_device(device)

    def t(a, dtype, rows=False):
        a = np.array(a)
        return torch.as_tensor(np.ascontiguousarray(a.T) if rows else a, dtype=dtype,
                               device=device)

    return LBVH(
        node_min=t(node_min, torch.float32), node_max=t(node_max, torch.float32),
        left=t(left, torch.int32), right=t(right, torch.int32), prim=t(prim, torch.int32),
        prim_valid=t(prim_valid, torch.bool), packed=t(packed_t, torch.float32, True),
        child=t(children, torch.int32, True), leaf_rows=t(leaf_t, torch.float32, True),
        unified=None if unified_t is None else t(unified_t, torch.float32, True),
        unified_child=None if unified_ci is None else t(unified_ci, torch.int32, True),
        leaf_size=int(leaf_size))
