"""Core struct-of-arrays records for the wavefront renderer.

Counterpart of ``mcrt_tpu/core/types.py``: each record is a small dataclass
of tensors with a flat leading ``(N, ...)`` axis.  ``TensorRecord`` gives
every record ``.to(device)`` and a functional ``replace``.

Code that runs every frame or bounce makes no tensor from host data with
``torch.tensor(..., device=cuda)`` or ``.to(cuda)``: a copy from pageable
host memory makes the host wait for the stream, so it could never run ahead
of the card.  It takes constants from ``device_constant``, and copies data
made per frame from pinned memory without blocking.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

F32_MAX = float(torch.finfo(torch.float32).max)


def from_host(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The CPU tensor ``host`` on ``device``: a card gets it by a
    non-blocking copy from pinned memory, so the host does not wait for the
    stream."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` where the caller names
    one, else the CUDA card.  Without a card it raises rather than run on
    the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device=\"cpu\" to run "
                           "on the CPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=64)
def device_constant(values: tuple, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small constant (a table) of ``dtype`` on ``device``, copied once and
    cached.  Callers must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def _move(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, TensorRecord):
        return v.to(device)
    return v


class TensorRecord:
    """Mixin for dataclasses whose fields are tensors (or nested records,
    or static Python values, which are left as they are)."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: _move(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
        })

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class Rays(TensorRecord):
    """A batch of rays. Inactive rays are masked via ``active``."""

    o: torch.Tensor  # (N, 3) origins
    d: torch.Tensor  # (N, 3) unit directions
    tmin: torch.Tensor  # (N,)
    tmax: torch.Tensor  # (N,)
    active: torch.Tensor  # (N,) bool

    @classmethod
    def make(cls, o, d, tmin=None, tmax=None, active=None):
        n, dev = o.shape[0], o.device
        if tmin is None:
            tmin = torch.zeros((n,), dtype=torch.float32, device=dev)
        if tmax is None:
            tmax = torch.full((n,), F32_MAX, dtype=torch.float32, device=dev)
        if active is None:
            active = torch.ones((n,), dtype=torch.bool, device=dev)
        return cls(o=o, d=d, tmin=tmin, tmax=tmax, active=active)

    @property
    def n(self) -> int:
        return self.o.shape[0]

    def at(self, t: torch.Tensor) -> torch.Tensor:
        return self.o + self.d * t[..., None]


@dataclass
class RayDiff(TensorRecord):
    """Directions of the rays through the +1-pixel neighbours in x and y."""

    dddx: torch.Tensor  # (N, 3)
    dddy: torch.Tensor  # (N, 3)


@dataclass
class Hit(TensorRecord):
    """Closest-hit record: t, primitive id, shape id, barycentric uv."""

    t: torch.Tensor  # (N,) hit distance (F32_MAX if miss)
    prim: torch.Tensor  # (N,) int32 (-1 if miss)
    shape: torch.Tensor  # (N,) int32 (-1 if miss)
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool

    @classmethod
    def none(cls, n: int, device=None) -> "Hit":
        """``n`` misses on ``default_device(device)``."""
        device = default_device(device)
        return cls(
            t=torch.full((n,), F32_MAX, dtype=torch.float32, device=device),
            prim=torch.full((n,), -1, dtype=torch.int32, device=device),
            shape=torch.full((n,), -1, dtype=torch.int32, device=device),
            u=torch.zeros((n,), dtype=torch.float32, device=device),
            v=torch.zeros((n,), dtype=torch.float32, device=device),
            valid=torch.zeros((n,), dtype=torch.bool, device=device),
        )


@dataclass
class Interaction(TensorRecord):
    """Surface interaction: position, frames, uv and its screen footprint."""

    p: torch.Tensor  # (N, 3)
    ng: torch.Tensor  # (N, 3) geometric normal
    ns: torch.Tensor  # (N, 3) shading normal
    dpdu: torch.Tensor  # (N, 3) shading tangent
    dpdv: torch.Tensor  # (N, 3) shading bitangent
    uv: torch.Tensor  # (N, 2)
    wo: torch.Tensor  # (N, 3) unit, towards the previous vertex
    duvdx: torch.Tensor | None  # (N, 2), None without ray differentials
    duvdy: torch.Tensor | None
    material: torch.Tensor  # (N,) int32
    light: torch.Tensor  # (N,) int32 area-light id (-1 if not emissive)
    valid: torch.Tensor  # (N,) bool


@dataclass
class Throughput(TensorRecord):
    """Per-path state carried across bounces."""

    beta: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3)
    specular_bounce: torch.Tensor  # (N,) bool
    active: torch.Tensor  # (N,) bool

    @classmethod
    def fresh(cls, n: int, device):
        return cls(
            beta=torch.ones((n, 3), dtype=torch.float32, device=device),
            radiance=torch.zeros((n, 3), dtype=torch.float32, device=device),
            specular_bounce=torch.zeros((n,), dtype=torch.bool, device=device),
            active=torch.ones((n,), dtype=torch.bool, device=device),
        )
