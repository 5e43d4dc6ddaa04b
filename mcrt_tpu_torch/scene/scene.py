"""Scene container (counterpart of ``mcrt_tpu/scene/scene.py``).

The device scene is a small tree of tensor dataclasses: world-space
triangle geometry with the packed per-face shading table, per-shape
records, the uber-material table with its static used-lobe mask, and the
light table.  Host-side assembly (``build_scene``, ``make_lights``) is the
JAX package's numpy code, so both packages build identical tables.

Not ported yet (ROADMAP): instanced shapes (``Scene.instances`` must be
None) and textures (``TextureAtlas`` is held only as an empty container).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.types import TensorRecord

LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_DISK = 2
LIGHT_MESH = 3  # triangle-mesh area light

TEX_DIFFUSE = 0
TEX_GLOSSY = 1
TEX_KR = 2
TEX_KT = 3
TEX_OPACITY = 4
TEX_ROUGHNESS = 5
TEX_IOR = 6
TEX_NORMAL = 7
N_TEX_SLOTS = 8

# packed face_attrs column layout (f32; ids stored as exact small floats)
FA_P0, FA_P1, FA_P2 = 0, 3, 6
FA_N0, FA_N1, FA_N2 = 9, 12, 15
FA_UV0, FA_UV1, FA_UV2 = 18, 20, 22
FA_MAT, FA_LIGHT = 24, 25
FA_COLS = 32


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def take_clip(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0, mode="clip")``: row gather with the
    index clamped into range."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


@dataclass
class Geometry(TensorRecord):
    """Flattened world-space triangle soup plus the (F, 32) packed per-face
    shading table ``face_attrs`` (vertex positions/normals/uvs, material and
    light id): one row gather per hit."""

    positions: torch.Tensor  # (V, 3) f32
    normals: torch.Tensor  # (V, 3) f32
    uvs: torch.Tensor  # (V, 2) f32
    indices: torch.Tensor  # (F, 3) i32
    face_shape: torch.Tensor  # (F,) i32
    face_valid: torch.Tensor  # (F,) bool
    face_attrs: torch.Tensor  # (F, 32) f32
    instanced: bool = False

    @property
    def num_faces(self) -> int:
        return self.indices.shape[0]

    def face_vertices(self, prim: torch.Tensor):
        idx = take_clip(self.indices, prim)
        return (take_clip(self.positions, idx[..., 0]),
                take_clip(self.positions, idx[..., 1]),
                take_clip(self.positions, idx[..., 2]))


def pack_face_attrs(positions, normals, uvs, indices, face_shape, face_valid,
                    shape_material, shape_light) -> torch.Tensor:
    """Build the (F, 32) packed per-face shading table."""
    f = indices.shape[0]
    cols = [take_clip(positions, indices[:, k]) for k in range(3)]
    cols += [take_clip(normals, indices[:, k]) for k in range(3)]
    cols += [take_clip(uvs, indices[:, k]) for k in range(3)]
    shp = face_shape.clamp_min(0)
    mat = torch.where(face_valid, take_clip(shape_material, shp), -1)
    lgt = torch.where(face_valid, take_clip(shape_light, shp), -1)
    cols.append(mat.to(torch.float32)[:, None])
    cols.append(lgt.to(torch.float32)[:, None])
    packed = torch.cat(cols, dim=1)
    pad = torch.zeros((f, FA_COLS - packed.shape[1]), dtype=torch.float32,
                      device=packed.device)
    return torch.cat([packed, pad], dim=1)


@dataclass
class Shapes(TensorRecord):
    material: torch.Tensor  # (S,) i32
    light: torch.Tensor  # (S,) i32 area light id, -1 if none
    to_world: torch.Tensor  # (S, 4, 4) f32
    normal_mat: torch.Tensor  # (S, 3, 3) f32


def material_masks(diffuse, glossy, kr, kt, opacity, tex, conductor_k,
                   rs_blend):
    """Static (used_slots, used_lobes) masks from host material arrays, as
    ``mcrt_tpu``'s ``Materials.stack`` computes them."""
    tex = np.asarray(tex)
    used_slots = tuple(bool(b) for b in (tex >= 0).any(axis=0))
    used_lobes = (
        bool((np.asarray(diffuse) > 0).any()),
        bool((np.asarray(glossy) > 0).any()),
        bool((np.asarray(kr) > 0).any()),
        bool((np.asarray(kt) > 0).any()),
        bool((np.asarray(opacity) < 1.0).any()
             or (tex[:, TEX_OPACITY] >= 0).any()
             or (tex[:, TEX_DIFFUSE] >= 0).any()),
        bool((np.asarray(conductor_k) > 0).any()),
        bool((np.asarray(rs_blend) > 0).any()),
    )
    return used_slots, used_lobes


@dataclass
class Materials(TensorRecord):
    """Uber-material table.  ``used_lobes`` is the static scene-wide lobe
    mask (diffuse, glossy, spec_refl, spec_trans, passthrough, conductor,
    fresnel_blend): lobes no material carries are skipped entirely."""

    diffuse: torch.Tensor  # (M, 3)
    glossy: torch.Tensor  # (M, 3)
    kr: torch.Tensor  # (M, 3)
    kt: torch.Tensor  # (M, 3)
    opacity: torch.Tensor  # (M, 3)
    roughness: torch.Tensor  # (M,)
    ior: torch.Tensor  # (M,)
    tex: torch.Tensor  # (M, 8) i32
    conductor_eta: torch.Tensor  # (M, 3)
    conductor_k: torch.Tensor  # (M, 3)
    rs_blend: torch.Tensor  # (M, 3)
    used_slots: tuple = (True,) * N_TEX_SLOTS
    used_lobes: tuple = (True,) * 7

    @classmethod
    def from_arrays(cls, device="cpu", **arrays):
        f32, i32 = torch.float32, torch.int32
        used_slots, used_lobes = material_masks(
            arrays["diffuse"], arrays["glossy"], arrays["kr"], arrays["kt"],
            arrays["opacity"], arrays["tex"], arrays["conductor_k"],
            arrays["rs_blend"])
        return cls(**{k: _t(v, i32 if k == "tex" else f32, device)
                      for k, v in arrays.items()},
                   used_slots=used_slots, used_lobes=used_lobes)

    @classmethod
    def stack(cls, mats: list["UberMaterial"], device="cpu"):
        names = ("diffuse", "glossy", "kr", "kt", "opacity", "roughness",
                 "ior", "tex", "conductor_eta", "conductor_k", "rs_blend")
        return cls.from_arrays(device=device, **{
            k: np.stack([np.asarray(getattr(mt, k)) for mt in mats])
            for k in names})


class UberMaterial:
    """Host-side material description."""

    def __init__(self, diffuse=(0.0, 0.0, 0.0), glossy=(0.0, 0.0, 0.0),
                 kr=(0.0, 0.0, 0.0), kt=(0.0, 0.0, 0.0),
                 opacity=(1.0, 1.0, 1.0), roughness=1.0, ior=1.5, tex=None,
                 conductor_eta=(0.2, 0.92, 1.1), conductor_k=(0.0, 0.0, 0.0),
                 rs_blend=(0.0, 0.0, 0.0)):
        self.diffuse = np.asarray(diffuse, np.float32)
        self.glossy = np.asarray(glossy, np.float32)
        self.kr = np.asarray(kr, np.float32)
        self.kt = np.asarray(kt, np.float32)
        self.opacity = np.asarray(opacity, np.float32)
        self.roughness = np.float32(roughness)
        self.ior = np.float32(ior)
        self.tex = (np.full((N_TEX_SLOTS,), -1, np.int32) if tex is None
                    else np.asarray(tex, np.int32))
        self.conductor_eta = np.asarray(conductor_eta, np.float32)
        self.conductor_k = np.asarray(conductor_k, np.float32)
        self.rs_blend = np.asarray(rs_blend, np.float32)


@dataclass
class Lights(TensorRecord):
    """Light table with uniform choice pdf.  Mesh area lights own the span
    [tri_offset, tri_offset + tri_count) of ``tri_index``/``tri_cdf``."""

    type: torch.Tensor  # (L,) i32
    position: torch.Tensor  # (L, 3)
    direction: torch.Tensor  # (L, 3)
    intensity: torch.Tensor  # (L, 3)
    radius: torch.Tensor  # (L,)
    area: torch.Tensor  # (L,)
    shape: torch.Tensor  # (L,) i32
    tri_offset: torch.Tensor  # (L,) i32
    tri_count: torch.Tensor  # (L,) i32
    tri_index: torch.Tensor  # (LT,) i32
    tri_cdf: torch.Tensor  # (LT,) f32 light-local area CDF
    tri_light: torch.Tensor  # (LT,) i32 owning light per entry
    num: int = 0

    @property
    def capacity(self) -> int:
        return self.type.shape[0]

    @classmethod
    def from_arrays(cls, device="cpu", **arrays):
        ints = ("type", "shape", "tri_offset", "tri_count", "tri_index",
                "tri_light")
        num = int(np.asarray(arrays.pop("num")))
        return cls(**{k: _t(v, torch.int32 if k in ints else torch.float32,
                            device) for k, v in arrays.items()}, num=num)

    @classmethod
    def empty(cls, device="cpu"):
        z = np.zeros((0,), np.float32)
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros((0,), np.int32)
        return cls.from_arrays(
            device, type=zi, position=z3, direction=z3, intensity=z3,
            radius=z, area=z, shape=zi, tri_offset=zi, tri_count=zi,
            tri_index=zi, tri_cdf=z, tri_light=zi, num=0)


@dataclass
class TextureAtlas(TensorRecord):
    """Held only as an empty container: texture sampling is not ported yet
    (ROADMAP), so a scene with ``num > 0`` textures is refused at shading."""

    num: int = 0


@dataclass
class Scene(TensorRecord):
    geometry: Geometry
    shapes: Shapes
    materials: Materials
    lights: Lights
    textures: TextureAtlas
    center: torch.Tensor  # (3,)
    radius: torch.Tensor  # ()
    instances: object | None = field(default=None)


def _pad_faces(indices: np.ndarray, face_shape: np.ndarray, multiple: int = 128):
    f = indices.shape[0]
    fp = ((f + multiple - 1) // multiple) * multiple
    pad = fp - f
    if pad:
        indices = np.concatenate([indices, np.zeros((pad, 3), np.int32)], 0)
        face_shape = np.concatenate([face_shape, np.full((pad,), -1, np.int32)], 0)
    valid = np.arange(fp) < f
    return indices, face_shape, valid


def build_scene(positions, normals, uvs, indices, face_shape, shape_material,
                materials: list[UberMaterial], lights: Lights | None = None,
                shape_light=None, pad_multiple: int = 128,
                device="cpu") -> Scene:
    """Assemble a Scene from host numpy arrays (world-space geometry)."""
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    face_shape = np.asarray(face_shape, np.int32)
    indices_p, face_shape_p, valid = _pad_faces(indices, face_shape, pad_multiple)
    num_shapes = len(shape_material)
    if shape_light is None:
        shape_light = np.full((num_shapes,), -1, np.int32)
    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    lo, hi = pos.min(0), pos.max(0)
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - center) + 1e-6)

    f32, i32 = torch.float32, torch.int32
    pos_t = _t(pos, f32, device)
    nrm_t = _t(np.asarray(normals, np.float32).reshape(-1, 3), f32, device)
    uvs_t = _t(np.asarray(uvs, np.float32).reshape(-1, 2), f32, device)
    idx_t = _t(indices_p, i32, device)
    fshape_t = _t(face_shape_p, i32, device)
    fvalid_t = _t(valid, torch.bool, device)
    smat_t = _t(np.asarray(shape_material, np.int32), i32, device)
    slight_t = _t(np.asarray(shape_light, np.int32), i32, device)
    return Scene(
        geometry=Geometry(
            positions=pos_t, normals=nrm_t, uvs=uvs_t, indices=idx_t,
            face_shape=fshape_t, face_valid=fvalid_t,
            face_attrs=pack_face_attrs(pos_t, nrm_t, uvs_t, idx_t, fshape_t,
                                       fvalid_t, smat_t, slight_t),
        ),
        shapes=Shapes(
            material=smat_t, light=slight_t,
            to_world=torch.eye(4, dtype=f32, device=device).repeat(num_shapes, 1, 1),
            normal_mat=torch.eye(3, dtype=f32, device=device).repeat(num_shapes, 1, 1),
        ),
        materials=Materials.stack(materials, device),
        lights=(lights.to(device) if lights is not None
                else Lights.empty(device)),
        textures=TextureAtlas(),
        center=_t(center, f32, device),
        radius=torch.tensor(radius, dtype=f32, device=device),
    )


def triangle_areas(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    p = positions[indices]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def make_lights(host_lights: list[dict], positions: np.ndarray,
                indices: np.ndarray, face_shape: np.ndarray,
                device="cpu") -> Lights:
    """Build the Lights table from host light descriptions (dicts with
    "type", "position", "direction", "intensity", "radius", "shape").
    Mesh lights get area-weighted triangle CDFs."""
    n_l = len(host_lights)
    typ = np.zeros((n_l,), np.int32)
    pos = np.zeros((n_l, 3), np.float32)
    dirn = np.zeros((n_l, 3), np.float32)
    inten = np.zeros((n_l, 3), np.float32)
    rad = np.zeros((n_l,), np.float32)
    area = np.zeros((n_l,), np.float32)
    shp = np.full((n_l,), -1, np.int32)
    tri_off = np.zeros((n_l,), np.int32)
    tri_cnt = np.zeros((n_l,), np.int32)
    tri_idx_all, tri_cdf_all, tri_light_all = [], [], []
    off = 0
    for i, hl in enumerate(host_lights):
        typ[i] = hl["type"]
        pos[i] = np.asarray(hl.get("position", (0, 0, 0)), np.float32)
        d = np.asarray(hl.get("direction", (0, -1, 0)), np.float32)
        n = np.linalg.norm(d)
        dirn[i] = d / (n if n > 0 else 1.0)
        inten[i] = np.asarray(hl.get("intensity", (1, 1, 1)), np.float32)
        rad[i] = float(hl.get("radius", 0.0))
        if typ[i] == LIGHT_DISK:
            area[i] = np.pi * rad[i] * rad[i]
        if typ[i] == LIGHT_MESH:
            s = int(hl["shape"])
            shp[i] = s
            tri_ids = np.nonzero(face_shape == s)[0].astype(np.int32)
            areas = triangle_areas(positions, indices[tri_ids])
            total = float(areas.sum())
            area[i] = total
            cdf = np.cumsum(areas / max(total, 1e-30)).astype(np.float32)
            tri_off[i] = off
            tri_cnt[i] = len(tri_ids)
            off += len(tri_ids)
            tri_idx_all.append(tri_ids)
            tri_cdf_all.append(cdf)
            tri_light_all.append(np.full((len(tri_ids),), i, np.int32))

    def cat(parts, dtype):
        return np.concatenate(parts) if parts else np.zeros((0,), dtype)

    return Lights.from_arrays(
        device, type=typ, position=pos, direction=dirn, intensity=inten,
        radius=rad, area=area, shape=shp, tri_offset=tri_off,
        tri_count=tri_cnt, tri_index=cat(tri_idx_all, np.int32),
        tri_cdf=cat(tri_cdf_all, np.float32),
        tri_light=cat(tri_light_all, np.int32), num=n_l)
