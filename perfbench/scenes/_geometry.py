"""Host geometry for the scene generators: a frozen copy of the port's
numpy builder helpers (``SceneBuffers`` without instancing, ``quad``,
``box``, ``icosphere``), and the ``SceneSpec`` they fill."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_MESH = 3
TEX_DIFFUSE = 0
TEX_NORMAL = 7
N_TEX_SLOTS = 8


@dataclass
class SceneSpec:
    """A scene as plain host data.  ``materials`` are keyword dicts of an
    uber material, ``lights`` host light dicts, ``textures`` (image, wrap)
    pairs in texture-id order, ``camera`` the keywords of a look-at."""

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray
    face_shape: np.ndarray
    shape_material: np.ndarray
    shape_light: np.ndarray
    materials: list
    lights: list
    camera: dict
    textures: list = field(default_factory=list)

    @property
    def num_faces(self) -> int:
        return int(self.indices.shape[0])


class SceneBuffers:
    """Mutable host-side geometry accumulator."""

    def __init__(self):
        self.positions, self.normals, self.uvs, self.indices = [], [], [], []
        self.face_shape, self.shape_material, self.shape_light = [], [], []
        self._voff = 0
        self._shape = 0

    def add_mesh(self, positions, indices, material_id, normals=None, uvs=None,
                 light_id=-1) -> int:
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        if normals is None:
            normals = _face_normals_to_vertex(positions, indices)
        if uvs is None:
            uvs = np.zeros((len(positions), 2), np.float32)
        self.positions.append(positions)
        self.normals.append(np.asarray(normals, np.float32).reshape(-1, 3))
        self.uvs.append(np.asarray(uvs, np.float32).reshape(-1, 2))
        self.indices.append(indices + self._voff)
        self.face_shape.append(np.full((len(indices),), self._shape, np.int32))
        self.shape_material.append(material_id)
        self.shape_light.append(light_id)
        self._voff += len(positions)
        sid = self._shape
        self._shape += 1
        return sid

    def spec(self, materials, lights, camera, textures=()) -> SceneSpec:
        return SceneSpec(
            positions=np.concatenate(self.positions),
            normals=np.concatenate(self.normals),
            uvs=np.concatenate(self.uvs),
            indices=np.concatenate(self.indices),
            face_shape=np.concatenate(self.face_shape),
            shape_material=np.asarray(self.shape_material, np.int32),
            shape_light=np.asarray(self.shape_light, np.int32),
            materials=list(materials), lights=list(lights), camera=dict(camera),
            textures=list(textures))


def _face_normals_to_vertex(positions, indices):
    normals = np.zeros_like(positions)
    p = positions[indices]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(lens, 1e-12)


def quad(p0, p1, p2, p3):
    """Two triangles for the quad p0-p1-p2-p3 (CCW)."""
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, idx


def box(lo, hi):
    """Axis-aligned box as 12 triangles with outward normals."""
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    faces = [
        quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # +z
        quad([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),  # -z
        quad([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),  # +x
        quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # -x
        quad([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),  # +y
        quad([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),  # -y
    ]
    pos = np.concatenate([f[0] for f in faces])
    idx = np.concatenate([f[1] + 4 * i for i, f in enumerate(faces)])
    return pos, idx


def icosphere(center, radius: float, subdiv: int = 2):
    """Icosahedron subdivided ``subdiv`` times, projected to a sphere.
    Returns (positions, indices, normals)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        verts = list(map(tuple, v))
        cache: dict[tuple, int] = {tuple(p): i for i, p in enumerate(verts)}

        def midpoint(a, b):
            mid = (v[a] + v[b]) / 2.0
            mid /= np.linalg.norm(mid)
            key = tuple(np.round(mid, 9))
            if key not in cache:
                cache[key] = len(verts)
                verts.append(tuple(mid))
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.asarray(verts, np.float64)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        f = np.asarray(nf, np.int64)
    normals = v.astype(np.float32)
    positions = (v * radius + np.asarray(center, np.float64)).astype(np.float32)
    return positions, f.astype(np.int32), normals
