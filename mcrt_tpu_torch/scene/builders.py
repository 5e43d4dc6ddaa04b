"""Procedural scene builders (counterpart of part of
``mcrt_tpu/scene/builders.py``): the host geometry accumulator with baked
and no-bake instancing, quad / box / icosphere primitives, the offline demo
scenes (``cornell_box``, ``glass_gallery``, the textured ``textured_hall``,
the instanced ``instanced_boxes``) and ``sphere_field`` with its instanced
form ``sphere_field_instanced``, the large stand-in scenes of the
main-path runs, and ``scene_from_obj``, a scene loaded from an OBJ file
with its MTL materials and texture files.  The numpy code of the scenes is
the JAX package's, so both packages build identical scenes.  Every builder
puts its scene on the CUDA card unless the caller names another
``device``.

Not ported yet (ROADMAP): the builders of ``bunny.obj`` scenes."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..camera.pinhole import PinholeCamera
from ..core.types import default_device
from .dynamic import rotation_y, scale, translation
from .scene import (LIGHT_DIRECTIONAL, LIGHT_MESH, LIGHT_POINT, N_TEX_SLOTS, TEX_DIFFUSE,
                    TEX_NORMAL, Instances, Scene, UberMaterial, build_scene, make_lights)
from .textures import AtlasBuilder


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
        # no-bake instances: (shape_id, src_shape, to_world (4,4))
        self.instances: list[tuple[int, int, np.ndarray]] = []
        self.shape_to_world: list[np.ndarray] = []
        self._voff = 0
        self._shape = 0
        self._face_count = 0
        self._mesh_face_range: dict[int, tuple[int, int]] = {}

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
        self.shape_to_world.append(np.eye(4, dtype=np.float32))
        sid = self._shape
        self._mesh_face_range[sid] = (self._face_count, self._face_count + len(indices))
        self._face_count += len(indices)
        self._shape += 1
        return sid

    def add_instanced(self, src_shape: int, material_id: int,
                      to_world: np.ndarray, light_id: int = -1) -> int:
        """Instance a previously added mesh without baking it: the new shape
        references the source mesh's faces and carries only a transform, so
        geometry and accel memory stay constant in the instance count.  The
        scene then renders through the two-level intersector.  Instanced
        shapes cannot be area lights (mesh-light CDFs index world-space
        faces): add an emitter as a baked mesh."""
        if light_id != -1:
            raise ValueError(
                "instanced shapes cannot carry mesh lights; add the emitter "
                "as a baked mesh (add_mesh / add_instance)")
        if src_shape not in self._mesh_face_range:
            raise ValueError(f"shape {src_shape} is not a source mesh")
        self.shape_material.append(material_id)
        self.shape_light.append(-1)
        self.shape_to_world.append(np.asarray(to_world, np.float32))
        sid = self._shape
        self._shape += 1
        self.instances.append((sid, src_shape, np.asarray(to_world, np.float32)))
        return sid

    def add_instance(self, src_shape: int, material_id: int,
                     to_world: np.ndarray, light_id: int = -1) -> int:
        """Instance a previously added shape under a new transform, baked:
        the instance gets its own world-space vertex block."""
        mt = np.asarray(to_world, np.float32)
        pos = self.positions[src_shape]
        p = pos @ mt[:3, :3].T + mt[:3, 3]
        nmat = np.linalg.inv(mt[:3, :3]).T
        n = self.normals[src_shape] @ nmat.T
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        # rebase the source indices to this instance's vertex block
        src_base = sum(len(v) for v in self.positions[:src_shape])
        local = self.indices[src_shape] - src_base
        return self.add_mesh(p, local, material_id, normals=n,
                             uvs=self.uvs[src_shape], light_id=light_id)

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

    def instance_table(self):
        """(shape_to_world (S, 4, 4), Instances or None) for build_scene."""
        tw = np.stack(self.shape_to_world).astype(np.float32)
        if not self.instances:
            return tw, None
        ranges = [self._mesh_face_range[i[1]] for i in self.instances]
        return tw, Instances(
            shape=torch.as_tensor([i[0] for i in self.instances], dtype=torch.int32),
            src_shape=torch.as_tensor([i[1] for i in self.instances], dtype=torch.int32),
            face_lo=tuple(r[0] for r in ranges), face_hi=tuple(r[1] for r in ranges))


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


def cornell_box(light_intensity=(17.0, 12.0, 4.0), device=None):
    """The Cornell-box fixture: Lambertian walls, two white boxes, one
    ceiling area light."""
    device = default_device(device)
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
        positions, indices, face_shape, device=device,
    )
    scene = build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                        materials, lights=lights, shape_light=shape_light,
                        device=device)
    camera = PinholeCamera.look_at(eye=(0.0, 1.0, 3.4), target=(0.0, 1.0, 0.0),
                                   fov_deg=40.0, aspect=1.0, device=device)
    return scene, camera


def scene_from_obj(path: str, camera_kw: dict | None = None, device=None):
    """A Scene from an OBJ file: one shape per OBJ material; materials with
    a nonzero Ke become triangle-mesh area lights of radiance Ke.  Texture
    files are decoded into the atlas and wired to the material slots:
    ``map_Kd`` linearized from sRGB into the diffuse slot, ``map_bump`` read
    linear into the normal-map slot; a missing file leaves the slot empty.
    The camera looks at the mesh's box unless ``camera_kw`` says
    otherwise."""
    from .objloader import load_obj
    from .textures import load_texture_image

    device = default_device(device)
    mesh = load_obj(path)

    sb = SceneBuffers()
    materials = [m.to_uber() for m in mesh.materials]
    base_dir = os.path.dirname(os.path.abspath(path))
    atlas_builder: AtlasBuilder | None = None
    tex_cache: dict[tuple, int] = {}
    for mid, om in enumerate(mesh.materials):
        for attr, slot, srgb in (("map_kd", TEX_DIFFUSE, True),
                                 ("map_bump", TEX_NORMAL, False)):
            rel = getattr(om, attr, None)
            if not rel:
                continue
            key = (rel, srgb)
            if key not in tex_cache:
                img = load_texture_image(os.path.join(base_dir, rel), srgb=srgb)
                if img is None:
                    tex_cache[key] = -1
                else:
                    if atlas_builder is None:
                        atlas_builder = AtlasBuilder()
                    tex_cache[key] = atlas_builder.add(img)
            if tex_cache[key] >= 0:
                materials[mid].tex[slot] = tex_cache[key]
    textures = atlas_builder.build() if atlas_builder is not None else None
    host_lights: list[dict] = []
    for mid in range(len(mesh.materials)):  # one shape per material group
        sel = mesh.face_material == mid
        if not sel.any():
            continue
        tri = mesh.indices[sel]
        used, inv = np.unique(tri.reshape(-1), return_inverse=True)
        light_id = -1
        ke = np.asarray(mesh.materials[mid].ke, np.float32)
        if ke.sum() > 0:
            light_id = len(host_lights)
        sid = sb.add_mesh(mesh.positions[used], inv.reshape(-1, 3).astype(np.int32), mid,
                          normals=mesh.normals[used], uvs=mesh.uvs[used], light_id=light_id)
        if light_id >= 0:
            host_lights.append({"type": LIGHT_MESH, "intensity": ke, "shape": sid})

    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    lights = make_lights(host_lights, positions, indices, face_shape, device=device)
    scene = build_scene(positions, normals, uvs, indices, face_shape, shape_mat, materials,
                        lights=lights, shape_light=shape_light, textures=textures,
                        device=device)
    lo, hi = positions.min(0), positions.max(0)
    center = (lo + hi) / 2
    size = float(np.linalg.norm(hi - lo))
    kw = dict(eye=center + np.asarray([0.0, 0.25 * size, 0.9 * size]), target=center,
              fov_deg=45.0, aspect=1.0)
    if camera_kw:
        kw.update(camera_kw)
    return scene, PinholeCamera.look_at(**kw, device=device)


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


def glass_gallery(device=None) -> tuple[Scene, PinholeCamera]:
    """Glossy Trowbridge-Reitz microfacet and specular-transmission spheres
    under a mesh area light (about 3.8k triangles)."""
    device = default_device(device)
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
        positions, indices, face_shape, device=device,
    )
    scene = build_scene(positions, normals, uvs, indices, face_shape,
                        shape_mat, list(GALLERY_MATERIALS), lights=lights,
                        shape_light=shape_light, device=device)
    camera = PinholeCamera.look_at(eye=(0.0, 2.2, 5.5), target=(0.0, 0.7, 0.0),
                                   fov_deg=42.0, aspect=1.0, device=device)
    return scene, camera


def _sphere_field(subdiv: int, instanced: bool, device) -> tuple[Scene, PinholeCamera]:
    device = default_device(device)
    sb = SceneBuffers()
    ext = 5.0
    fp, fi = quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext])
    sb.add_mesh(fp, fi, 0)
    unit_p, unit_i, unit_n = icosphere((0.0, 0.0, 0.0), 0.6, subdiv=subdiv)
    centers = [np.asarray([(k % 4 - 1.5) * 1.6, 0.6, (k // 4 - 1.0) * 1.6], np.float32)
               for k in range(12)]
    src = sb.add_mesh(unit_p + centers[0], unit_i, 1, normals=unit_n)
    for k in range(1, 12):
        if instanced:
            sb.add_instanced(src, 1 + k % 3, translation(centers[k] - centers[0]))
        else:
            sb.add_mesh(unit_p + centers[k], unit_i, 1 + k % 3, normals=unit_n)
    lp, li = quad([-1.5, 4.0, -1.5], [1.5, 4.0, -1.5], [1.5, 4.0, 1.5],
                  [-1.5, 4.0, 1.5])
    light_shape = sb.add_mesh(lp, li, 4, light_id=0)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    tw, instances = sb.instance_table()
    lights = make_lights([{"type": LIGHT_MESH, "intensity": (14.0, 13.0, 12.0),
                           "shape": light_shape}], positions, indices, face_shape,
                         device=device)
    scene = build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                        list(GALLERY_MATERIALS), lights=lights,
                        shape_light=shape_light, shape_to_world=tw,
                        instances=instances, device=device)
    camera = PinholeCamera.look_at(eye=(0.0, 3.2, 7.5), target=(0.0, 0.5, 0.0),
                                   fov_deg=45.0, aspect=1.0, device=device)
    return scene, camera


def sphere_field(subdiv: int = 5, device=None) -> tuple[Scene, PinholeCamera]:
    """12 icospheres on a 4x3 grid over a floor quad, lit by a mesh area
    light, with the ``glass_gallery`` material set.  At ``subdiv=5``
    (20,480 triangles a sphere) it has 245,764 triangles: an offline
    stand-in of the JAX bench's ``bunny_field`` (about 244k triangles),
    which needs an OBJ file outside the repository."""
    return _sphere_field(subdiv, False, device)


def sphere_field_instanced(subdiv: int = 5, device=None) -> tuple[Scene, PinholeCamera]:
    """``sphere_field`` with the sphere added once and placed in the 11
    other cells by no-bake instances (``SceneBuffers.add_instanced``): the
    same materials, light, camera and content (245,764 triangles at
    ``subdiv=5``), with one shared 20,480-triangle BLAS.  It stands in for
    the JAX package's ``bunny_field_instanced``, which needs an OBJ file
    outside the repository, and is the instanced form of the main path's
    scene, so the two renders of the same content can be compared."""
    return _sphere_field(subdiv, True, device)


def _checkerboard(n: int = 256, tiles: int = 8, c0=(0.85, 0.82, 0.75),
                  c1=(0.25, 0.2, 0.18)) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = ((xx * tiles // n + yy * tiles // n) % 2).astype(bool)
    return np.where(mask[..., None], np.asarray(c1, np.float32),
                    np.asarray(c0, np.float32))


def _ridge_normal_map(n: int = 256, freq: int = 12, amp: float = 0.35) -> np.ndarray:
    """Tangent-space sine-ridge normal map encoded in [0, 1]."""
    x = np.linspace(0, 2 * np.pi * freq, n, dtype=np.float32)
    dz = amp * np.cos(x)  # d(height)/du
    nm = np.zeros((n, n, 3), np.float32)
    nm[..., 0] = (-dz / np.sqrt(1 + dz * dz))[None, :]
    nm[..., 1] = 0.0
    nm[..., 2] = (1.0 / np.sqrt(1 + dz * dz))[None, :]
    return nm * 0.5 + 0.5


def textured_hall(with_uvs_scale: float = 4.0, device=None) -> tuple[Scene, PinholeCamera]:
    """A hall of checkerboard-textured and normal-mapped uber materials lit
    by a point and a directional light (44 triangles): the JAX package's
    stand-in of its BASELINE configuration 3 (Sponza's material and light
    coverage), which pairs with the Sobol sampler."""
    device = default_device(device)
    atlas_b = AtlasBuilder()
    tid_check = atlas_b.add(_checkerboard())
    tid_warm = atlas_b.add(_checkerboard(tiles=16, c0=(0.8, 0.55, 0.35),
                                         c1=(0.5, 0.3, 0.2)))
    tid_nm = atlas_b.add(_ridge_normal_map())

    tex_floor = np.full((N_TEX_SLOTS,), -1, np.int32)
    tex_floor[TEX_DIFFUSE] = tid_check
    tex_floor[TEX_NORMAL] = tid_nm
    tex_wall = np.full((N_TEX_SLOTS,), -1, np.int32)
    tex_wall[TEX_DIFFUSE] = tid_warm
    mats = [
        UberMaterial(diffuse=(1.0, 1.0, 1.0), glossy=(0.15, 0.15, 0.15),
                     roughness=0.2, tex=tex_floor),
        UberMaterial(diffuse=(1.0, 1.0, 1.0), tex=tex_wall),
        UberMaterial(diffuse=(0.7, 0.7, 0.7)),
    ]

    sb = SceneBuffers()
    s, h, d = 4.0, 3.0, 8.0
    u = with_uvs_scale

    def quad_uv(p0, p1, p2, p3):
        pos, idx = quad(p0, p1, p2, p3)
        return pos, idx, np.asarray([[0, 0], [u, 0], [u, u], [0, u]], np.float32)

    pos, idx, uvs = quad_uv([-s, 0, d], [s, 0, d], [s, 0, -d], [-s, 0, -d])
    sb.add_mesh(pos, idx, 0, uvs=uvs)  # floor: textured and normal-mapped
    pos, idx, uvs = quad_uv([-s, 0, -d], [-s, 0, d], [-s, h, d], [-s, h, -d])
    sb.add_mesh(pos, idx, 1, uvs=uvs)  # left wall
    pos, idx, uvs = quad_uv([s, 0, d], [s, 0, -d], [s, h, -d], [s, h, d])
    sb.add_mesh(pos, idx, 1, uvs=uvs)  # right wall
    pos, idx, uvs = quad_uv([-s, 0, -d], [-s, h, -d], [s, h, -d], [s, 0, -d])
    sb.add_mesh(pos, idx, 2, uvs=uvs)  # back wall
    for cx in (-2.0, 0.0, 2.0):  # columns
        p, i2 = box([cx - 0.25, 0.0, -2.0], [cx + 0.25, h * 0.8, -1.5])
        sb.add_mesh(p, i2, 2)

    positions, normals, uvs_a, indices, face_shape, shape_mat, shape_light = sb.concat()
    lights = make_lights(
        [{"type": LIGHT_POINT, "position": (0.0, h * 0.85, 1.0),
          "intensity": (30.0, 28.0, 24.0)},
         {"type": LIGHT_DIRECTIONAL, "direction": (-0.3, -1.0, -0.45),
          "intensity": (2.5, 2.4, 2.2)}],
        positions, indices, face_shape, device=device)
    scene = build_scene(positions, normals, uvs_a, indices, face_shape, shape_mat, mats,
                        lights=lights, shape_light=shape_light,
                        textures=atlas_b.build(), device=device)
    camera = PinholeCamera.look_at(eye=(0.0, 1.8, 6.5), target=(0.0, 1.0, -2.0),
                                   fov_deg=55.0, aspect=1.0, device=device)
    return scene, camera


def instanced_boxes(grid: int = 3, bake: bool = False,
                    device=None) -> tuple[Scene, PinholeCamera]:
    """A floor, a grid of instances of one source box mesh (varied
    rotations, scales and materials) and a baked emissive quad.
    ``bake=True`` builds the same scene from baked world-space copies
    (``add_instance``), the reference for the two-level engine."""
    device = default_device(device)
    sb = SceneBuffers()
    ext = grid * 0.9
    pos, idx = quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext])
    sb.add_mesh(pos, idx, 0)  # floor
    pos, idx = box([-0.25, 0.0, -0.25], [0.25, 0.55, 0.25])
    src = sb.add_mesh(pos, idx, 1)  # the source mesh renders at its own pose

    rng_l = np.random.default_rng(11)
    for gx in range(grid):
        for gz in range(grid):
            if gx == 0 and gz == 0:
                continue  # the source occupies cell (0, 0)
            x = (gx - (grid - 1) / 2) * 1.5
            z = (gz - (grid - 1) / 2) * 1.5
            mt = (translation((x, 0.0, z))
                  @ rotation_y(float(rng_l.uniform(0, np.pi)))
                  @ scale((1.0, float(rng_l.uniform(0.6, 1.6)), 1.0)))
            mat = 1 + (gx + gz) % 3
            if bake:
                sb.add_instance(src, mat, mt)
            else:
                sb.add_instanced(src, mat, mt)

    # baked emissive quad overhead (mesh lights must be baked), wound so its
    # geometric normal faces down into the scene
    h = 2.2
    pos, idx = quad([-0.8, h, -0.8], [0.8, h, -0.8], [0.8, h, 0.8], [-0.8, h, 0.8])
    light_shape = sb.add_mesh(pos, idx, 4, light_id=0)

    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    tw, instances = sb.instance_table()
    materials = [
        UberMaterial(diffuse=(0.70, 0.70, 0.70)),
        UberMaterial(diffuse=(0.72, 0.25, 0.20)),
        UberMaterial(diffuse=(0.25, 0.55, 0.72), glossy=(0.2, 0.2, 0.2),
                     roughness=0.25),
        UberMaterial(diffuse=(0.30, 0.65, 0.30)),
        UberMaterial(diffuse=(0.0, 0.0, 0.0)),
    ]
    lights = make_lights([{"type": LIGHT_MESH, "intensity": (10.0, 9.5, 8.5),
                           "shape": light_shape}], positions, indices, face_shape,
                         device=device)
    scene = build_scene(positions, normals, uvs, indices, face_shape, shape_mat, materials,
                        lights=lights, shape_light=shape_light,
                        shape_to_world=tw, instances=instances, device=device)
    camera = PinholeCamera.look_at(eye=(0.0, grid * 1.1, grid * 1.9), target=(0.0, 0.3, 0.0),
                                   fov_deg=50.0, aspect=1.0, device=device)
    return scene, camera
