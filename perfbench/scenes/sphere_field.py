"""``sphere_field``: 12 icospheres on a 4x3 grid over a floor quad, lit by
a mesh area light, with the gallery's materials (diffuse floor, gold-ish
glossy, glass, blue glossy).  At ``subdiv=5`` it has 245,764 triangles.
A frozen copy of the port's builder (``scene/builders.py: sphere_field``),
the offline stand-in of the JAX bench's ``bunny_field``."""
from __future__ import annotations

import numpy as np

from ._geometry import LIGHT_MESH, SceneBuffers, icosphere, quad

GALLERY_MATERIALS = (
    dict(diffuse=(0.55, 0.55, 0.58)),                              # floor
    dict(glossy=(0.9, 0.75, 0.4), roughness=0.08),                 # gold-ish
    dict(kt=(0.95, 0.95, 0.95), kr=(0.1, 0.1, 0.1),
         diffuse=(0.0, 0.0, 0.0), roughness=0.0, ior=1.5),         # glass
    dict(glossy=(0.4, 0.45, 0.8), diffuse=(0.1, 0.1, 0.25),
         roughness=0.25),                                          # blue glossy
    dict(diffuse=(0.0, 0.0, 0.0)),                                 # emitter
)


def build(subdiv: int = 5):
    sb = SceneBuffers()
    ext = 5.0
    fp, fi = quad([-ext, 0, ext], [ext, 0, ext], [ext, 0, -ext], [-ext, 0, -ext])
    sb.add_mesh(fp, fi, 0)
    unit_p, unit_i, unit_n = icosphere((0.0, 0.0, 0.0), 0.6, subdiv=subdiv)
    centers = [np.asarray([(k % 4 - 1.5) * 1.6, 0.6, (k // 4 - 1.0) * 1.6], np.float32)
               for k in range(12)]
    for k in range(12):
        sb.add_mesh(unit_p + centers[k], unit_i, 1 + k % 3, normals=unit_n)
    lp, li = quad([-1.5, 4.0, -1.5], [1.5, 4.0, -1.5], [1.5, 4.0, 1.5],
                  [-1.5, 4.0, 1.5])
    light_shape = sb.add_mesh(lp, li, 4, light_id=0)
    lights = [{"type": LIGHT_MESH, "intensity": (14.0, 13.0, 12.0), "shape": light_shape}]
    camera = dict(eye=(0.0, 3.2, 7.5), target=(0.0, 0.5, 0.0), fov_deg=45.0, aspect=1.0)
    return sb.spec(GALLERY_MATERIALS, lights, camera)
