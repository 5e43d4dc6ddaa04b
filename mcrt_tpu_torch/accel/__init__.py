"""Acceleration-structure registry (counterpart of ``mcrt_tpu/accel/__init__.py``).

``build_intersector`` builds the accel for a scene and binds the
(closest-hit, any-hit) query pair.  The port has four engines:

- the blocked intersector, under ``AccelType.AUTO`` and ``BLOCKED``: scenes
  of at most ``blocked.DENSE_BLOCKS`` blocks take its dense path (kernels
  K4/K5), larger ones its visit-list path (K1-K3);
- the two-level intersector (K1 over pair boxes, then K6/K7), which
  instanced scenes take under ``AUTO`` and ``TWO_LEVEL``; a scene without
  instances under ``TWO_LEVEL`` renders as one free BLAS under an identity
  instance;
- the LBVH under ``LBVH``: a Morton/Karras tree built on the scene's
  device (``lbvh.py``) and walked by a lockstep stack loop in PyTorch
  (``traverse.py``);
- the brute-force oracle under ``BRUTE`` (``brute.py``): every ray against
  every triangle, with no accel (``accel=None``).

``AUTO`` takes the blocked intersector on every device.  The JAX
package's ``AUTO`` does so on the TPU, the card's counterpart, and takes
the oracle (at most 4,096 faces) or the LBVH elsewhere; the port keeps the
blocked path on the CPU too, where its tests hold the kernels' plain
versions.

On a CUDA device the blocked and two-level queries launch the kernels; on
the CPU they run the kernels' plain PyTorch versions (the choice is made
by the tensors' device).  The LBVH and the oracle are plain PyTorch on
every device.  ``parallel/ring.py: build_sharded_scene`` binds a fifth
``Intersector``, the ray ring over face shards: each ring step runs the
blocked queries on the rank's ``ShardedBlockedAccel``, or the oracle on
the rank's faces (``use_blocked=False``).  Every engine's queries are
bound by ``bind_queries``, which opens their spans and tallies their live
rays while a profiler records (``utils/profiling.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import AccelType, BVHConfig, RenderConfig  # noqa: F401
from ..core.types import Hit, Rays
from ..scene.scene import Instances, Scene
from ..utils.profiling import span, tally
from .brute import intersect_brute, occluded_brute


# The blocked queries sort their rays for coherence only from this many
# blocks on: the sort pays off only when culling can skip blocks, so the
# dense path (K4/K5) is handed its rays in the renderer's order.
SORT_MIN_BLOCKS = 8


class Intersector(NamedTuple):
    """Bound query functions: (scene, rays) -> Hit / blocked mask."""

    intersect: Callable[[Scene, Rays], Hit]
    occluded: Callable[[Scene, Rays], torch.Tensor]
    accel: object


def bind_queries(closest_query: Callable[[Scene, Rays], Hit],
                 occluded_query: Callable[[Scene, Rays], torch.Tensor], accel) -> Intersector:
    """An ``Intersector`` whose queries each open a ``mcrt.query.closest`` /
    ``mcrt.query.occluded`` span and tally their live rays
    (``rays.closest`` / ``rays.occluded``) while a profiler records."""

    def intersect(s, r):
        with span("mcrt.query.closest"):
            tally("rays.closest", r.active)
            return closest_query(s, r)

    def occluded(s, r):
        with span("mcrt.query.occluded"):
            tally("rays.occluded", r.active)
            return occluded_query(s, r)

    return Intersector(intersect, occluded, accel)


def blocked_intersector(acc, sort: bool | None = None) -> Intersector:
    """Bind blocked-accel query closures around an accel.  ``sort`` says
    whether the queries sort their rays for coherence; by default they do
    from ``SORT_MIN_BLOCKS`` blocks on."""
    from .blocked import intersect_blocked, occluded_blocked

    if sort is None:
        sort = acc.num_blocks >= SORT_MIN_BLOCKS
    return bind_queries(lambda s, r: intersect_blocked(s.geometry, acc, r, sort=sort),
                        lambda s, r: occluded_blocked(s.geometry, acc, r, sort=sort), acc)


def two_level_intersector(acc) -> Intersector:
    """Bind pair-list two-level query closures around an accel."""
    from .two_level import intersect_two_level, occluded_two_level

    return bind_queries(lambda s, r: intersect_two_level(s.geometry, acc, r),
                        lambda s, r: occluded_two_level(s.geometry, acc, r), acc)


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
    if cfg.accel == AccelType.BRUTE:
        return bind_queries(lambda s, r: intersect_brute(s.geometry, r),
                            lambda s, r: occluded_brute(s.geometry, r), None)
    if cfg.accel == AccelType.LBVH:
        from .lbvh import build_lbvh
        from .traverse import intersect_bvh, occluded_bvh

        bvh = build_lbvh(scene.geometry, cfg.bvh)
        return bind_queries(lambda s, r: intersect_bvh(s.geometry, bvh, r, cfg.bvh),
                            lambda s, r: occluded_bvh(s.geometry, bvh, r, cfg.bvh), bvh)
    if cfg.accel not in (AccelType.AUTO, AccelType.BLOCKED):
        raise ValueError(f"unknown accel {cfg.accel}")
    from .blocked import build_blocked

    return blocked_intersector(build_blocked(scene.geometry, cfg.bvh))
