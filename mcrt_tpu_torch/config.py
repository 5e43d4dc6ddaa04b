"""Typed configuration tree (a copy of ``mcrt_tpu/config.py``).

The JAX package's config is plain dataclasses and enums, but importing it
imports ``mcrt_tpu/__init__.py`` and therefore jax, so the port carries its
own copy.  The two must stay field-for-field identical: the tests build one
config for both packages from the same values.  Frozen dataclasses,
serializable to/from plain dicts.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any


class SamplerType(str, enum.Enum):
    """``RT_SAMPLER`` compile-time switch (``samplers.cl:16-18``)."""

    RANDOM = "random"
    SOBOL = "sobol"


class FilterType(str, enum.Enum):
    """Pixel reconstruction filters (``filters.cl:12-69``)."""

    BOX = "box"
    TRIANGLE = "triangle"
    GAUSSIAN = "gaussian"
    MITCHELL = "mitchell"
    LANCZOS = "lanczos"


class IntegratorType(str, enum.Enum):
    """Pipeline switch: raster is GUI-only in the reference; here PT vs BDPT
    (``PathTracingApp.cpp:83-109``)."""

    PATH = "path"
    BDPT = "bdpt"


class AccelType(str, enum.Enum):
    """Acceleration structure choice — analogue of the reference's
    ``acc.type`` option (bvh / fatbvh / hlbvh, ``RTScene.cpp:203-238``)."""

    BRUTE = "brute"  # O(N) all-triangles oracle (conformance reference)
    LBVH = "lbvh"  # device-built Morton LBVH, JAX traversal
    BLOCKED = "blocked"  # Pallas blocked-dense kernel (TPU-native default)
    TWO_LEVEL = "two_level"  # instanced: shared BLASes + pair-list kernels
    AUTO = "auto"  # pick per scene size (Commit-time strategy selection)


class BuilderType(str, enum.Enum):
    """BVH builder: device LBVH (cf. ``hlbvh.cpp``), host binned-SAH
    (cf. ``bvh.cpp`` FindSahSplit), or host SBVH with spatial splits
    (cf. ``split_bvh.h:30-45``)."""

    LBVH = "lbvh"
    SAH = "sah"
    SBVH = "sbvh"


@dataclass(frozen=True)
class FilterConfig:
    """``RTFilterProperties`` (``kernel_data.h:63-80``) knobs."""

    type: FilterType = FilterType.BOX
    radius: float = 0.5
    gaussian_alpha: float = 2.0
    mitchell_b: float = 1.0 / 3.0
    mitchell_c: float = 1.0 / 3.0
    lanczos_tau: float = 3.0


@dataclass(frozen=True)
class SamplerConfig:
    type: SamplerType = SamplerType.RANDOM
    seed: int = 0


@dataclass(frozen=True)
class BVHConfig:
    """BVH knobs — analogue of ``IntersectionAPISettings``
    (``PathTracingSettings.h:157-255``)."""

    builder: BuilderType = BuilderType.SAH
    # LBVH morton grid resolution bits per axis
    morton_bits: int = 10
    # SAH builder knobs (host builder, quality option)
    sah_bins: int = 16
    traversal_cost: float = 1.0
    max_leaf_size: int = 2  # 2 activates the unified single-gather traversal table
    # traversal
    stack_depth: int = 64
    # SBVH spatial-split knobs (split_bvh.h:30-45 analogues)
    max_split_depth: int = 16  # spatial splits allowed above this depth
    min_overlap: float = 1e-5  # L/R overlap area fraction that triggers them
    extra_refs_budget: float = 0.5  # duplicated references <= budget * ntri


@dataclass(frozen=True)
class IntegratorConfig:
    """GISettings analogue (``PathTracingSettings.h:50-145``): default
    max_depth=2 matches the reference default (:81)."""

    type: IntegratorType = IntegratorType.PATH
    max_depth: int = 2
    enable_shadows: bool = True  # RT_ENABLE_SHADOWS (kernel_data.h:10)
    trace_offset: float = 1e-4  # RT_TRACE_OFFSET geometric ray-spawn offset
    max_trace_distance: float = 1e6  # RT_MAX_TRACE_DISTANCE
    max_radiance: float = 1000.0  # RT_MAX_ALLOWED_RADIANCE clamp (kernel_data.h:13)
    # improvement over reference: MIS-weighted NEE (reference uses plain NEE
    # with emitter hits counted only on bounce 0 / after specular)
    use_mis: bool = False
    # improvement over reference: PBRT-style Russian roulette from this
    # bounce on (0 = off, matching the reference's fixed-depth termination).
    # Unbiased: survivors reweight by 1/q with q = max throughput component
    rr_start_depth: int = 0


@dataclass(frozen=True)
class DenoiseConfig:
    enabled: bool = False
    radius: int = 3
    sigma_spatial: float = 2.0
    sigma_range: float = 0.25


@dataclass(frozen=True)
class ToneMapConfig:
    enabled: bool = False
    l_white: float = 4.0  # extended Reinhard white point (ToneMapping.cl:32-63)


@dataclass(frozen=True)
class ShardingConfig:
    """Distribution knobs — new capability (SURVEY §2e): shard image tiles
    and spp across a device mesh; ``psum`` merges radiance and gradients."""

    mesh_axes: tuple[str, ...] = ("spp", "rays")
    mesh_shape: tuple[int, ...] = (1, 1)
    shard_scene: bool = False  # San-Miguel-scale: shard BVH + ray ring


@dataclass(frozen=True)
class RenderConfig:
    width: int = 128
    height: int = 128
    spp: int = 64
    samples_per_pass: int = 1  # spp folded into one jitted call
    integrator: IntegratorConfig = field(default_factory=IntegratorConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    accel: AccelType = AccelType.AUTO
    bvh: BVHConfig = field(default_factory=BVHConfig)
    denoise: DenoiseConfig = field(default_factory=DenoiseConfig)
    tonemap: ToneMapConfig = field(default_factory=ToneMapConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    # pause conditions for progressive rendering (stopAtFrame / stopAtTime,
    # GUI/PathTracingSettings.h:46-47 + RTPathTracingPass.cpp:56-58);
    # 0 = no limit
    stop_at_spp: int = 0
    stop_at_time_s: float = 0.0


# ----------------------------------------------------------------------------
# dict/YAML round-trip (the reference has no config files; this adds them)
# ----------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, enum.Enum):
        return cfg.value
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def _from_dict(cls: type, d: Any) -> Any:
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in (d or {}).items():
        if k not in hints:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        f = hints[k]
        t = f.type if isinstance(f.type, type) else None
        default = getattr(cls, k, None) if not dataclasses.is_dataclass(cls) else None
        # resolve via default instances for nested dataclasses / enums
        proto = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default  # type: ignore
        if dataclasses.is_dataclass(proto):
            kwargs[k] = _from_dict(type(proto), v)
        elif isinstance(proto, enum.Enum):
            kwargs[k] = type(proto)(v)
        elif isinstance(proto, tuple):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def from_dict(d: dict) -> RenderConfig:
    return _from_dict(RenderConfig, d)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
