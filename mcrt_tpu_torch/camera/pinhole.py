"""Pinhole camera with frustum-corner-ray parametrization (counterpart of
``mcrt_tpu/camera/pinhole.py``): per-pixel directions are the normalized
bilinear interpolation of the 4 frustum corner directions.

The BDPT importance functions (``eval_we``, ``pdf_we``, ``sample_wi``) wait
with BDPT (ROADMAP)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import math as m
from ..core.types import RayDiff, TensorRecord, device_constant


@dataclass
class PinholeCamera(TensorRecord):
    position: torch.Tensor  # (3,)
    c00: torch.Tensor  # (3,) bottom-left corner direction
    c10: torch.Tensor  # (3,) bottom-right
    c01: torch.Tensor  # (3,) top-left
    c11: torch.Tensor  # (3,) top-right
    forward: torch.Tensor  # (3,)
    area: torch.Tensor  # () film area on the z=1 plane
    tan_half_fov: torch.Tensor  # ()
    aspect: torch.Tensor  # ()
    right: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)

    @classmethod
    def look_at(cls, eye, target, up=(0.0, 1.0, 0.0), fov_deg: float = 45.0,
                aspect: float = 1.0, device="cpu"):
        f32 = torch.float32
        eye = torch.as_tensor(eye, dtype=f32, device=device)
        target = torch.as_tensor(target, dtype=f32, device=device)
        up = torch.as_tensor(up, dtype=f32, device=device)
        fwd = m.normalize(target - eye)
        right = m.normalize(m.cross(fwd, up))
        true_up = m.cross(right, fwd)
        # f32 fov * f32(pi/180), as jnp.deg2rad evaluates it
        rad = (torch.tensor(fov_deg, dtype=f32)
               * torch.tensor(math.pi / 180.0, dtype=f32))
        t = torch.tan(rad * 0.5).to(device)
        asp = torch.tensor(aspect, dtype=f32, device=device)
        hx = t * asp
        hy = t
        c00 = m.normalize(fwd - right * hx - true_up * hy)
        c10 = m.normalize(fwd + right * hx - true_up * hy)
        c01 = m.normalize(fwd - right * hx + true_up * hy)
        c11 = m.normalize(fwd + right * hx + true_up * hy)
        return cls(position=eye, c00=c00, c10=c10, c01=c01, c11=c11,
                   forward=fwd, area=4.0 * hx * hy, tan_half_fov=t,
                   aspect=asp, right=right, up=true_up)

    def generate_rays(self, uv: torch.Tensor):
        """Per-pixel camera rays from film uv in [0,1]^2 ((N, 2))."""
        d = m.lerp_direction(self.c00, self.c10, self.c01, self.c11, uv)
        o = self.position.expand(d.shape)
        return o, d

    def generate_ray_differentials(self, uv: torch.Tensor, width: int,
                                   height: int) -> RayDiff:
        """Directions of the rays through the +1-pixel neighbours."""
        du = device_constant((1.0 / width, 0.0), uv.device)
        dv = device_constant((0.0, 1.0 / height), uv.device)
        corners = (self.c00, self.c10, self.c01, self.c11)
        return RayDiff(dddx=m.lerp_direction(*corners, uv + du),
                       dddy=m.lerp_direction(*corners, uv + dv))


def pixel_uv(width: int, height: int, jitter: torch.Tensor | None = None,
             device="cpu") -> torch.Tensor:
    """uv at pixel centers (+ optional jitter in pixel units), flattened
    row-major to (W*H, 2).  v=0 is the bottom row."""
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
    if jitter is not None:
        uv = uv + jitter.to(device) / device_constant(
            (float(width), float(height)), torch.device(device))
    return uv
