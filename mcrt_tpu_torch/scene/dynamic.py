"""Dynamic scene updates (counterpart of ``mcrt_tpu/scene/dynamic.py``):
per-shape transforms, refit and the accumulation reset.

A ``SceneAnimator`` snapshots the base (build-time) scene, and
``transformed`` maps (S, 4, 4) per-shape transforms to a new ``Scene``:
every vertex and normal re-transformed from the snapshot (so repeated
edits never drift), mesh-light areas and CDFs and the bounding sphere
refreshed.  The new scene shares the base's ``indices`` and ``face_valid``
tensors, which is what ``Renderer.update_scene`` reads as "the same faces,
moved": it then refits the accel instead of rebuilding it.
``set_shape_transform`` edits an instanced shape's transform alone, which
``update_scene`` refits as an instance-only edit.  ``make_animated_frame``
chains transform, refit and a progressive frame.  All of it is torch ops
on the scene's device: an animated frame on the card makes no host sync.

The host 4x4 helpers ``translation``, ``scale`` and ``rotation_y`` place
shapes in the builders.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.math import inverse3
from ..core.types import TensorRecord, from_host
from .scene import LIGHT_MESH, Lights, Scene, pack_face_attrs, take_clip


def _on(device, m) -> torch.Tensor:
    """A float32 tensor of ``m`` on ``device``.  Host data is copied from
    pinned memory without blocking, so the host does not wait for the
    card."""
    if isinstance(m, torch.Tensor) and m.device == device:
        return m.to(torch.float32)
    return from_host(torch.as_tensor(np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m,
                                                np.float32)), device)


def _normal_matrices(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverse-transposes of the shapes' 3x3 parts."""
    return inverse3(rot).transpose(-1, -2)


def _apply(mats: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(V, 3) rows ``mats @ v`` for (V, 3, 3) matrices."""
    return (mats * v[:, None, :]).sum(-1)


def vertex_shape_ids(scene: Scene) -> torch.Tensor:
    """(V,) int32 owning shape of each vertex, from the face table.  Shapes
    never share vertices (``SceneBuffers.add_mesh`` gives each its own
    block), so a scatter from the faces is exact."""
    geom = scene.geometry
    vs = torch.zeros((geom.positions.shape[0],), dtype=torch.int32,
                     device=geom.positions.device)
    fs = torch.where(geom.face_valid, geom.face_shape, 0)
    for k in range(3):
        vs = vs.scatter_reduce(0, geom.indices[:, k].long(), fs, reduce="amax")
    return vs


def _tri_areas(positions: torch.Tensor, indices: torch.Tensor,
               tri_ids: torch.Tensor) -> torch.Tensor:
    idx = take_clip(indices, tri_ids)
    p0, p1, p2 = (take_clip(positions, idx[:, k]) for k in range(3))
    return 0.5 * torch.linalg.vector_norm(torch.linalg.cross(p1 - p0, p2 - p0), dim=-1)


def _refresh_mesh_lights(lights: Lights, positions: torch.Tensor,
                         indices: torch.Tensor) -> Lights:
    """Mesh-light areas and per-light area CDFs after a transform."""
    if lights.tri_index.shape[0] == 0:
        return lights
    areas = _tri_areas(positions, indices, lights.tri_index)  # (LT,)
    owner = lights.tri_light.long()
    total = torch.zeros((lights.capacity,), dtype=areas.dtype,
                        device=areas.device).index_add_(0, owner, areas)
    cum = torch.cumsum(areas, 0)
    prev = torch.cat([torch.zeros((1,), dtype=areas.dtype, device=areas.device),
                      torch.cumsum(total, 0)[:-1]])
    cdf = (cum - prev[owner]) / total.clamp_min(1e-20)[owner]
    area = torch.where(lights.type == LIGHT_MESH, total, lights.area)
    return lights.replace(area=area, tri_cdf=cdf)


@dataclass
class SceneAnimator(TensorRecord):
    """Base-scene snapshot and per-vertex shape ids; maps per-shape
    transforms to a new world-space ``Scene``."""

    base: Scene
    vertex_shape: torch.Tensor  # (V,) i32

    @classmethod
    def create(cls, scene: Scene) -> "SceneAnimator":
        return cls(base=scene, vertex_shape=vertex_shape_ids(scene))

    def transformed(self, to_world) -> Scene:
        """The base scene under ``to_world`` ((S, 4, 4), a tensor or host
        array): vertices and normals re-transformed from the snapshot, light
        areas and CDFs, the bounding sphere and the shape table refreshed.
        ``indices`` and ``face_valid`` are the base's own tensors."""
        geom = self.base.geometry
        m = _on(geom.positions.device, to_world)  # (S, 4, 4)
        nmat = _normal_matrices(m[:, :3, :3])  # (S, 3, 3)
        mv = take_clip(m, self.vertex_shape)  # (V, 4, 4)
        p = _apply(mv[:, :3, :3], geom.positions) + mv[:, :3, 3]
        n = _apply(take_clip(nmat, self.vertex_shape), geom.normals)
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-20)

        lo, hi = p.amin(dim=0), p.amax(dim=0)
        center = (lo + hi) * 0.5
        radius = torch.linalg.vector_norm(hi - center) + 1e-6
        shapes = self.base.shapes
        new_geom = geom.replace(
            positions=p, normals=n,
            face_attrs=pack_face_attrs(p, n, geom.uvs, geom.indices, geom.face_shape,
                                       geom.face_valid, shapes.material, shapes.light))
        return self.base.replace(
            geometry=new_geom,
            shapes=shapes.replace(to_world=m, normal_mat=nmat),
            lights=_refresh_mesh_lights(self.base.lights, p, geom.indices),
            center=center, radius=radius)

    def identity_transforms(self) -> np.ndarray:
        s = self.base.shapes.material.shape[0]
        return np.broadcast_to(np.eye(4, dtype=np.float32), (s, 4, 4)).copy()

    def set_transform(self, shape_idx: int, matrix, transforms=None) -> Scene:
        """Set one shape's transform on top of ``transforms`` ((S, 4, 4), a
        tensor or host array; the identity for every shape by default) and
        return the transformed scene."""
        if transforms is None:
            t = self.identity_transforms()
        else:
            t = np.array(torch.as_tensor(transforms).cpu(), np.float32)
        t[shape_idx] = np.asarray(matrix, np.float32)
        return self.transformed(t)


def set_shape_transform(scene: Scene, shape_id: int, matrix) -> Scene:
    """Transform edit of an instanced shape: a new ``shapes.to_world`` row
    (and normal matrix) with the geometry untouched, which
    ``Renderer.update_scene`` refits as an instance-only edit.  Baked
    shapes' vertices must move: use ``SceneAnimator`` for them."""
    shapes = scene.shapes
    m = _on(shapes.to_world.device, matrix)
    to_world = shapes.to_world.clone()
    to_world[shape_id] = m
    normal_mat = shapes.normal_mat.clone()
    normal_mat[shape_id] = _normal_matrices(m[:3, :3])
    return scene.replace(shapes=shapes.replace(to_world=to_world, normal_mat=normal_mat))


def make_animated_frame(animator: SceneAnimator, camera, cfg, base_accel=None):
    """Transform, refit and render: returns ``frame_fn(to_world, accum,
    frame) -> (scene, accum)``, which moves the base scene by ``to_world``,
    refits the base scene's blocked accel with ``refit_blocked`` and folds
    one progressive frame into ``accum``.  ``base_accel`` is a blocked
    accel of the base scene already built (then no host build runs at
    all); without it, one is built here.  No host build runs after this
    call."""
    from ..accel import blocked_intersector
    from ..accel.blocked import build_blocked, refit_blocked
    from ..renderer import render_frame_fn

    if base_accel is None:
        base_accel = build_blocked(animator.base.geometry, cfg.bvh)

    def frame_fn(to_world, accum, frame):
        scene = animator.transformed(to_world)
        inter = blocked_intersector(refit_blocked(base_accel, scene.geometry))
        with torch.no_grad():
            return scene, render_frame_fn(scene, camera, accum, frame, cfg, inter)

    return frame_fn


def translation(offset) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(offset, np.float32)
    return t


def scale(factors) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[0, 0], t[1, 1], t[2, 2] = np.broadcast_to(np.asarray(factors, np.float32), (3,))
    return t


def rotation_y(angle_rad: float) -> np.ndarray:
    c, s = float(np.cos(angle_rad)), float(np.sin(angle_rad))
    t = np.eye(4, dtype=np.float32)
    t[0, 0], t[0, 2], t[2, 0], t[2, 2] = c, s, -s, c
    return t
