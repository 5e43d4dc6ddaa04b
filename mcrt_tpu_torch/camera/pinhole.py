"""Pinhole camera with frustum-corner-ray parametrization (counterpart of
``mcrt_tpu/camera/pinhole.py``): per-pixel directions are the normalized
bilinear interpolation of the 4 frustum corner directions, and the
importance functions that BDPT's t=1 strategies use (``world_to_uv``,
``eval_we``, ``pdf_we``, ``sample_wi``), each over any leading shape."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import math as m
from ..core.types import RayDiff, TensorRecord, default_device, device_constant


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
                aspect: float = 1.0, device=None):
        f32 = torch.float32
        device = default_device(device)
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

    # importance transport (BDPT t=1 strategies)

    def world_to_uv(self, d: torch.Tensor):
        """Project a world direction from the eye onto film uv; returns
        (uv, in_frustum)."""
        dz = m.dot(d, self.forward)
        ok = dz > 1e-6
        inv = torch.where(ok, 1.0 / torch.where(ok, dz, 1.0), 0.0)
        x = m.dot(d, self.right) * inv
        y = m.dot(d, self.up) * inv
        hx = self.tan_half_fov * self.aspect
        hy = self.tan_half_fov
        u = (x / hx) * 0.5 + 0.5
        v = (y / hy) * 0.5 + 0.5
        inside = ok & (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
        return torch.stack([u, v], dim=-1), inside

    def eval_we(self, d: torch.Tensor) -> torch.Tensor:
        """Importance We(d) of a ray leaving the eye in unit direction d:
        1/(A cos^4) on the z=1 film plane, 0 outside the frustum.  The
        powers are the JAX package's ``integer_pow`` products."""
        _, inside = self.world_to_uv(d)
        cos_t = m.dot(d, self.forward)
        cos2 = cos_t * cos_t
        w = m.safe_div(torch.ones_like(cos_t), self.area * (cos2 * cos2))
        return torch.where(inside, w, 0.0)

    def pdf_we(self, d: torch.Tensor):
        """(pdf_pos, pdf_dir) of emitting a ray in direction d: the pinhole's
        position is a delta (1), pdf_dir = 1/(A cos^3)."""
        _, inside = self.world_to_uv(d)
        cos_t = m.dot(d, self.forward)
        pdf_dir = m.safe_div(torch.ones_like(cos_t), self.area * (cos_t * (cos_t * cos_t)))
        return torch.ones_like(cos_t), torch.where(inside, pdf_dir, 0.0)

    def sample_wi(self, ref_p: torch.Tensor):
        """The (delta) direction from scene points to the eye for the t=1
        connection: (wi, distance, We, pdf, uv, inside), the pdf in solid
        angle at the point (dist^2 / cos)."""
        to_cam = self.position - ref_p
        dist2 = m.length_sq(to_cam)
        dist = torch.sqrt(dist2)
        wi = to_cam / torch.clamp_min(dist[..., None], 1e-20)
        uv, inside = self.world_to_uv(-wi)
        we = self.eval_we(-wi)
        cos_t = m.dot(-wi, self.forward)
        pdf = m.safe_div(dist2, torch.clamp_min(cos_t, 1e-8))
        return wi, dist, we, pdf, uv, inside


def pixel_uv(width: int, height: int, jitter: torch.Tensor | None = None,
             device=None) -> torch.Tensor:
    """uv at pixel centers (+ optional jitter in pixel units), flattened
    row-major to (W*H, 2).  v=0 is the bottom row."""
    device = default_device(device)
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
    if jitter is not None:
        uv = uv + jitter.to(device) / device_constant(
            (float(width), float(height)), device)
    return uv
