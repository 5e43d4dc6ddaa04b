"""``textured_hall``: a hall of checkerboard-textured and normal-mapped
uber materials lit by a point and a directional light (44 triangles, three
256x256 textures).  A frozen copy of the port's builder
(``scene/builders.py: textured_hall``), the JAX package's stand-in of its
BASELINE configuration 3 (Crytek Sponza's material and light coverage)."""
from __future__ import annotations

import numpy as np

from ._geometry import (LIGHT_DIRECTIONAL, LIGHT_POINT, N_TEX_SLOTS, TEX_DIFFUSE,
                        TEX_NORMAL, SceneBuffers, box, quad)


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


def build(with_uvs_scale: float = 4.0):
    textures = [(_checkerboard(), 0),
                (_checkerboard(tiles=16, c0=(0.8, 0.55, 0.35), c1=(0.5, 0.3, 0.2)), 0),
                (_ridge_normal_map(), 0)]
    tid_check, tid_warm, tid_nm = 0, 1, 2
    tex_floor = np.full((N_TEX_SLOTS,), -1, np.int32)
    tex_floor[TEX_DIFFUSE] = tid_check
    tex_floor[TEX_NORMAL] = tid_nm
    tex_wall = np.full((N_TEX_SLOTS,), -1, np.int32)
    tex_wall[TEX_DIFFUSE] = tid_warm
    mats = [
        dict(diffuse=(1.0, 1.0, 1.0), glossy=(0.15, 0.15, 0.15), roughness=0.2,
             tex=tex_floor),
        dict(diffuse=(1.0, 1.0, 1.0), tex=tex_wall),
        dict(diffuse=(0.7, 0.7, 0.7)),
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
    lights = [{"type": LIGHT_POINT, "position": (0.0, h * 0.85, 1.0),
               "intensity": (30.0, 28.0, 24.0)},
              {"type": LIGHT_DIRECTIONAL, "direction": (-0.3, -1.0, -0.45),
               "intensity": (2.5, 2.4, 2.2)}]
    camera = dict(eye=(0.0, 1.8, 6.5), target=(0.0, 1.0, -2.0), fov_deg=55.0, aspect=1.0)
    return sb.spec(mats, lights, camera, textures)
