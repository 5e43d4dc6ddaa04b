"""Acceleration-structure registry (counterpart of ``mcrt_tpu/accel/__init__.py``).

``build_intersector`` builds the accel for a scene and binds the
(closest-hit, any-hit) query pair.  The port has two engines:

- the blocked intersector, under ``AccelType.AUTO`` and ``BLOCKED``: scenes
  of at most ``blocked.DENSE_BLOCKS`` blocks take its dense path (kernels
  K4/K5), larger ones its visit-list path (K1-K3);
- the two-level intersector (K1 over pair boxes, then K6/K7), which
  instanced scenes take under ``AUTO`` and ``TWO_LEVEL``; a scene without
  instances under ``TWO_LEVEL`` renders as one free BLAS under an identity
  instance.

On a CUDA device the queries launch the kernels; on the CPU they run the
kernels' plain PyTorch versions (the choice is made by the tensors'
device).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import AccelType, RenderConfig
from ..core.types import Hit, Rays
from ..scene.scene import Instances, Scene


# The blocked queries sort their rays for coherence only from this many
# blocks on: the sort pays off only when culling can skip blocks, so the
# dense path (K4/K5) is handed its rays in the renderer's order.
SORT_MIN_BLOCKS = 8


class Intersector(NamedTuple):
    """Bound query functions: (scene, rays) -> Hit / blocked mask."""

    intersect: Callable[[Scene, Rays], Hit]
    occluded: Callable[[Scene, Rays], torch.Tensor]
    accel: object


def blocked_intersector(acc) -> Intersector:
    """Bind blocked-accel query closures around an accel."""
    from .blocked import intersect_blocked, occluded_blocked

    sort = acc.num_blocks >= SORT_MIN_BLOCKS
    return Intersector(
        intersect=lambda s, r: intersect_blocked(s.geometry, acc, r, sort=sort),
        occluded=lambda s, r: occluded_blocked(s.geometry, acc, r, sort=sort),
        accel=acc,
    )


def two_level_intersector(acc) -> Intersector:
    """Bind pair-list two-level query closures around an accel."""
    from .two_level import intersect_two_level, occluded_two_level

    return Intersector(
        intersect=lambda s, r: intersect_two_level(s.geometry, acc, r),
        occluded=lambda s, r: occluded_two_level(s.geometry, acc, r),
        accel=acc,
    )


_NOT_PORTED = {
    AccelType.LBVH: "Queue 1, LBVH and the brute oracle: LBVH is retired from the port",
    AccelType.BRUTE: "Queue 1, LBVH and the brute oracle: the oracle stays in the JAX "
                     "package",
}


def build_intersector(scene: Scene, cfg: RenderConfig) -> Intersector:
    """Build the accel for ``scene`` and bind its query closures."""
    if scene.instances is not None:
        # every other accel sees only the source meshes' object-space faces
        if cfg.accel not in (AccelType.AUTO, AccelType.TWO_LEVEL):
            raise ValueError(
                f"scene has instanced shapes; accel={cfg.accel.value!r} cannot "
                "render them: use AccelType.AUTO or TWO_LEVEL")
        instances = scene.instances
    elif cfg.accel == AccelType.TWO_LEVEL:
        empty = torch.zeros((0,), dtype=torch.int32)
        instances = Instances(shape=empty, src_shape=empty)
    else:
        instances = None
    if instances is not None:
        from .two_level import build_two_level_scene

        return two_level_intersector(build_two_level_scene(
            scene.geometry, scene.shapes.to_world, instances, cfg.bvh))
    if cfg.accel in _NOT_PORTED:
        raise NotImplementedError(
            f"accel={cfg.accel.value!r} is not ported yet (ROADMAP: "
            f"{_NOT_PORTED[cfg.accel]}); use AccelType.AUTO or BLOCKED")
    if cfg.accel not in (AccelType.AUTO, AccelType.BLOCKED):
        raise ValueError(f"unknown accel {cfg.accel}")
    from .blocked import build_blocked

    return blocked_intersector(build_blocked(scene.geometry, cfg.bvh))
