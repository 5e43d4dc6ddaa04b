"""Acceleration-structure registry (counterpart of ``mcrt_tpu/accel/__init__.py``).

``build_intersector`` builds the accel for a scene and binds the
(closest-hit, any-hit) query pair.  The port has one engine so far, the
blocked intersector: ``AccelType.AUTO`` and ``BLOCKED`` select it on every
device.  On a CUDA device its queries launch the kernels K1-K3; on the CPU
they run the kernels' plain PyTorch versions (the wrappers decide by the
tensors' device).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import AccelType, RenderConfig
from ..core.types import Hit, Rays
from ..scene.scene import Scene


class Intersector(NamedTuple):
    """Bound query functions: (scene, rays) -> Hit / blocked mask."""

    intersect: Callable[[Scene, Rays], Hit]
    occluded: Callable[[Scene, Rays], torch.Tensor]
    accel: object


def blocked_intersector(acc) -> Intersector:
    """Bind blocked-accel query closures around an accel."""
    from .blocked import intersect_blocked, occluded_blocked

    # the coherence sort pays off only when culling can skip blocks
    sort = acc.num_blocks >= 8
    return Intersector(
        intersect=lambda s, r: intersect_blocked(s.geometry, acc, r, sort=sort),
        occluded=lambda s, r: occluded_blocked(s.geometry, acc, r, sort=sort),
        accel=acc,
    )


_NOT_PORTED = {
    AccelType.TWO_LEVEL: "two-level K6/K7",
    AccelType.LBVH: "LBVH (Queue 1 item 17: retire from the port)",
    AccelType.BRUTE: "the brute-force oracle",
}


def build_intersector(scene: Scene, cfg: RenderConfig) -> Intersector:
    """Build the accel for ``scene`` and bind its query closures."""
    if scene.instances is not None:
        raise NotImplementedError(
            "instanced scenes need the two-level intersector, not ported yet "
            "(ROADMAP, Queue 1: two-level with K6/K7)")
    if cfg.accel in _NOT_PORTED:
        raise NotImplementedError(
            f"accel={cfg.accel.value!r} is not ported yet (ROADMAP: "
            f"{_NOT_PORTED[cfg.accel]}); use AccelType.AUTO or BLOCKED")
    if cfg.accel not in (AccelType.AUTO, AccelType.BLOCKED):
        raise ValueError(f"unknown accel {cfg.accel}")
    from .blocked import build_blocked

    return blocked_intersector(build_blocked(scene.geometry, cfg.bvh))
