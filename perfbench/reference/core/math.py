"""Vector / geometry math helpers (counterpart of ``mcrt_tpu/core/math.py``).

Everything is batched over leading axes and branch-free; the formulas and
their evaluation order follow the JAX package so that the two agree to
float32 rounding.

Clips go through ``fmax``, ``fmin`` and ``fclip``, not ``torch.clamp``, so
that their gradients are the JAX package's too: at a tie with the bound,
``jnp.maximum`` and ``jnp.clip`` pass half the gradient, ``torch.clamp``
all of it, and parameters sit exactly on such bounds (roughness 1.0,
diffuse 0, opaque texels).
"""
from __future__ import annotations

import torch

from .types import device_constant

EPS = 1e-6
F32_MAX = float(torch.finfo(torch.float32).max)


def _scalar(c: float, like: torch.Tensor) -> torch.Tensor:
    return device_constant((float(c),), like.device)[0]


def fmax(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: a tie passes half the gradient to ``x``."""
    return torch.maximum(x, _scalar(c, x))


def fmin(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.minimum(x, c)``: a tie passes half the gradient to ``x``."""
    return torch.minimum(x, _scalar(c, x))


def fclip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, the minimum of the maximum."""
    return fmin(fmax(x, lo), hi)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis (keepdim False)."""
    return torch.sum(a * b, dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis (keepdim True)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def length_sq(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: v/|v|; zero vectors stay finite."""
    return v * torch.rsqrt(fmax(torch.sum(v * v, dim=-1, keepdim=True), eps))


def lerp(a, b, t):
    return a + (b - a) * t


def lerp_direction(c00, c10, c01, c11, uv):
    """Normalized bilinear interpolation of 4 frustum corner directions."""
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    bottom = lerp(c00, c10, u)
    top = lerp(c01, c11, u)
    return normalize(lerp(bottom, top, v))


def reflect(wo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return -wo + 2.0 * dot3(wo, n) * n


def faceforward(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(dot3(n, v) < 0.0, -n, n)


def orthogonal_vector(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to v (cross with the smallest-magnitude axis)."""
    ax = torch.abs(v[..., 0:1])
    ay = torch.abs(v[..., 1:2])
    az = torch.abs(v[..., 2:3])
    use_x = (ax <= ay) & (ax <= az)
    use_y = (~use_x) & (ay <= az)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    axis = torch.where(use_x, eye[0], torch.where(use_y, eye[1], eye[2]))
    return normalize(cross(v, axis))


def build_orthonormal_basis(n: torch.Tensor):
    """Branch-free ONB from a unit normal (Duff et al. 2017).
    Returns (t, b) with [t, b, n] right-handed orthonormal."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], dim=-1
    )
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def spherical_direction(sin_theta, cos_theta, phi):
    """Direction from spherical coords in the y-up shading frame."""
    return torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)], dim=-1
    )


def to_local(t, b, n, v):
    """World -> shading space (y-up): (t·v, n·v, b·v)."""
    return torch.stack([dot(t, v), dot(n, v), dot(b, v)], dim=-1)


def to_world(t, b, n, v):
    """Shading space (y-up) -> world."""
    return v[..., 0:1] * t + v[..., 1:2] * n + v[..., 2:3] * b


def solve_2x2(a00, a01, a10, a11, b0, b1):
    """Batched 2x2 linear solve; returns (x0, x1, ok)."""
    det = a00 * a11 - a01 * a10
    ok = torch.abs(det) >= 1e-10
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    x0 = (a11 * b0 - a01 * b1) * inv_det
    x1 = (a00 * b1 - a10 * b0) * inv_det
    return x0, x1, ok


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return p @ m[..., :3, :3].transpose(-1, -2) + m[..., :3, 3]


def transform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v @ m[..., :3, :3].transpose(-1, -2)


def transform_normal(m_inv: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return n @ m_inv[..., :3, :3]


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance."""
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def is_black(rgb: torch.Tensor) -> torch.Tensor:
    return torch.all(rgb == 0.0, dim=-1)


def safe_div(a, b, eps: float = 0.0):
    """a/b with 0 where |b| <= eps."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(fmax(x, 0.0))


def distance_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sum(d * d, dim=-1)


def inverse3(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) inverses: the adjugate (transposed cofactors) over the
    determinant, in elementwise ops, so on the card it needs no solver and
    makes no host sync."""
    c = [[m[..., (i + 1) % 3, (j + 1) % 3] * m[..., (i + 2) % 3, (j + 2) % 3]
          - m[..., (i + 1) % 3, (j + 2) % 3] * m[..., (i + 2) % 3, (j + 1) % 3]
          for j in range(3)] for i in range(3)]  # cofactors
    det = m[..., 0, 0] * c[0][0] + m[..., 0, 1] * c[0][1] + m[..., 0, 2] * c[0][2]
    return torch.stack([torch.stack([c[j][i] / det for j in range(3)], -1)
                        for i in range(3)], -2)
