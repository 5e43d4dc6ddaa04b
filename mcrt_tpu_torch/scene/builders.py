"""Procedural scene builders (counterpart of part of
``mcrt_tpu/scene/builders.py``): the host geometry accumulator, quad / box
/ icosphere primitives, the two offline demo scenes the port's tests use
and ``sphere_field``, the large stand-in scene of the main-path runs.  The
numpy code of the first two is the JAX package's, so both build identical
scenes.

Not ported yet (ROADMAP): instanced shapes (``add_instanced``), OBJ-based
scenes and the textured demo scenes."""
from __future__ import annotations

import numpy as np

from ..camera.pinhole import PinholeCamera
from .scene import LIGHT_MESH, Scene, UberMaterial, build_scene, make_lights


class SceneBuffers:
    """Mutable host-side geometry accumulator."""

    def __init__(self):
        self.positions: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.uvs: list[np.ndarray] = []
        self.indices: list[np.ndarray] = []
        self.face_shape: list[np.ndarray] = []
        self.shape_material: list[int] = []
        self.shape_light: list[int] = []
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

    def concat(self):
        return (
            np.concatenate(self.positions),
            np.concatenate(self.normals),
            np.concatenate(self.uvs),
            np.concatenate(self.indices),
            np.concatenate(self.face_shape),
            np.asarray(self.shape_material, np.int32),
            np.asarray(self.shape_light, np.int32),
        )


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


def cornell_box(light_intensity=(17.0, 12.0, 4.0), device="cpu"):
    """The Cornell-box fixture: Lambertian walls, two white boxes, one
    ceiling area light."""
    sb = SceneBuffers()
    white, red, green, light_m = 0, 1, 2, 3
    s = 1.0
    pos, idx = quad([-s, 0, s], [s, 0, s], [s, 0, -s], [-s, 0, -s])
    sb.add_mesh(pos, idx, white)
    pos, idx = quad([-s, 2 * s, -s], [s, 2 * s, -s], [s, 2 * s, s], [-s, 2 * s, s])
    sb.add_mesh(pos, idx, white)
    pos, idx = quad([-s, 0, -s], [s, 0, -s], [s, 2 * s, -s], [-s, 2 * s, -s])
    sb.add_mesh(pos, idx, white)
    pos, idx = quad([-s, 0, s], [-s, 0, -s], [-s, 2 * s, -s], [-s, 2 * s, s])
    sb.add_mesh(pos, idx, red)
    pos, idx = quad([s, 0, -s], [s, 0, s], [s, 2 * s, s], [s, 2 * s, -s])
    sb.add_mesh(pos, idx, green)
    pos, idx = box([-0.55, 0.0, -0.55], [-0.05, 1.0, -0.15])
    sb.add_mesh(pos, idx, white)
    pos, idx = box([0.1, 0.0, 0.0], [0.6, 0.5, 0.5])
    sb.add_mesh(pos, idx, white)
    ls = 0.35
    # wound so the geometric normal faces down (-y) into the box
    pos, idx = quad(
        [-ls, 2 * s - 1e-3, -ls], [ls, 2 * s - 1e-3, -ls],
        [ls, 2 * s - 1e-3, ls], [-ls, 2 * s - 1e-3, ls],
    )
    light_shape = sb.add_mesh(pos, idx, light_m, light_id=0)

    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    materials = [
        UberMaterial(diffuse=(0.73, 0.73, 0.73)),
        UberMaterial(diffuse=(0.63, 0.065, 0.05)),
        UberMaterial(diffuse=(0.14, 0.45, 0.091)),
        UberMaterial(diffuse=(0.0, 0.0, 0.0)),
    ]
    lights = make_lights(
        [{"type": LIGHT_MESH, "intensity": light_intensity, "shape": light_shape}],
        positions, indices, face_shape,
    )
    scene = build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                        materials, lights=lights, shape_light=shape_light,
                        device=device)
    camera = PinholeCamera.look_at(eye=(0.0, 1.0, 3.4), target=(0.0, 1.0, 0.0),
                                   fov_deg=40.0, aspect=1.0, device=device)
    return scene, camera


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


GALLERY_MATERIALS = (
    UberMaterial(diffuse=(0.55, 0.55, 0.58)),                       # floor
    UberMaterial(glossy=(0.9, 0.75, 0.4), roughness=0.08),          # gold-ish
    UberMaterial(kt=(0.95, 0.95, 0.95), kr=(0.1, 0.1, 0.1),
                 diffuse=(0.0, 0.0, 0.0), roughness=0.0, ior=1.5),  # glass
    UberMaterial(glossy=(0.4, 0.45, 0.8), diffuse=(0.1, 0.1, 0.25),
                 roughness=0.25),                                   # blue glossy
    UberMaterial(diffuse=(0.0, 0.0, 0.0)),                          # emitter
)


def glass_gallery(device="cpu") -> tuple[Scene, PinholeCamera]:
    """Glossy Trowbridge-Reitz microfacet and specular-transmission spheres
    under a mesh area light (about 3.8k triangles)."""
    sb = SceneBuffers()
    ext = 4.0
    fp, fi = quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext])
    sb.add_mesh(fp, fi, 0)
    for mid, (cx, cz) in zip((1, 2, 3), ((-1.6, 0.0), (0.0, 0.6), (1.6, -0.2))):
        p, idx, n = icosphere((cx, 0.75, cz), 0.75, subdiv=3)
        sb.add_mesh(p, idx, mid, normals=n)
    lp, li = quad([-1.2, 3.5, -1.2], [1.2, 3.5, -1.2], [1.2, 3.5, 1.2],
                  [-1.2, 3.5, 1.2])
    light_shape = sb.add_mesh(lp, li, 4, light_id=0)

    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    lights = make_lights(
        [{"type": LIGHT_MESH, "intensity": (14.0, 13.0, 12.0),
          "shape": light_shape}],
        positions, indices, face_shape,
    )
    scene = build_scene(positions, normals, uvs, indices, face_shape,
                        shape_mat, list(GALLERY_MATERIALS), lights=lights,
                        shape_light=shape_light, device=device)
    camera = PinholeCamera.look_at(eye=(0.0, 2.2, 5.5), target=(0.0, 0.7, 0.0),
                                   fov_deg=42.0, aspect=1.0, device=device)
    return scene, camera


def sphere_field(subdiv: int = 5, device="cpu") -> tuple[Scene, PinholeCamera]:
    """12 icospheres on a 4x3 grid over a floor quad, lit by a mesh area
    light, with the ``glass_gallery`` material set.  At ``subdiv=5``
    (20,480 triangles a sphere) it has 245,764 triangles: an offline
    stand-in of the JAX bench's ``bunny_field`` (about 244k triangles),
    which needs an OBJ file outside the repository."""
    sb = SceneBuffers()
    ext = 5.0
    fp, fi = quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext])
    sb.add_mesh(fp, fi, 0)
    unit_p, unit_i, unit_n = icosphere((0.0, 0.0, 0.0), 0.6, subdiv=subdiv)
    for k in range(12):
        gx, gz = k % 4, k // 4
        center = np.asarray([(gx - 1.5) * 1.6, 0.6, (gz - 1.0) * 1.6], np.float32)
        sb.add_mesh(unit_p + center, unit_i, 1 + k % 3, normals=unit_n)
    lp, li = quad([-1.5, 4.0, -1.5], [1.5, 4.0, -1.5], [1.5, 4.0, 1.5],
                  [-1.5, 4.0, 1.5])
    light_shape = sb.add_mesh(lp, li, 4, light_id=0)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    lights = make_lights([{"type": LIGHT_MESH, "intensity": (14.0, 13.0, 12.0),
                           "shape": light_shape}], positions, indices, face_shape)
    scene = build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                        list(GALLERY_MATERIALS), lights=lights,
                        shape_light=shape_light, device=device)
    camera = PinholeCamera.look_at(eye=(0.0, 3.2, 7.5), target=(0.0, 0.5, 0.0),
                                   fov_deg=45.0, aspect=1.0, device=device)
    return scene, camera
