"""Sampling primitives + MIS heuristics (counterpart of
``mcrt_tpu/sampling/samplers.py``).  Shading space is y-up."""
from __future__ import annotations

import math

import torch

from ..core import math as m

INV_PI = 1.0 / math.pi
INV_2PI = 0.5 / math.pi


def uniform_hemisphere(u: torch.Tensor):
    """y-up unit hemisphere; pdf = 1/(2π)."""
    cos_t = u[..., 0]
    sin_t = m.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * u[..., 1]
    return m.spherical_direction(sin_t, cos_t, phi)


def uniform_hemisphere_pdf():
    return INV_2PI


def uniform_sphere(u: torch.Tensor):
    cos_t = 1.0 - 2.0 * u[..., 0]
    sin_t = m.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * u[..., 1]
    return m.spherical_direction(sin_t, cos_t, phi)


def uniform_sphere_pdf():
    return 1.0 / (4.0 * math.pi)


def concentric_disk(u: torch.Tensor):
    """Shirley-Chiu concentric disk map, branch-free."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * m.safe_div(oy, ox),
        (math.pi / 2.0) - (math.pi / 4.0) * m.safe_div(ox, oy),
    )
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], dim=-1)


def cosine_hemisphere(u: torch.Tensor):
    """y-up cosine-weighted hemisphere via the concentric disk; pdf = cosθ/π."""
    d = concentric_disk(u)
    y = m.safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.stack([d[..., 0], y, d[..., 1]], dim=-1)


def cosine_hemisphere_pdf(cos_theta: torch.Tensor):
    return torch.abs(cos_theta) * INV_PI


def uniform_cone(u: torch.Tensor, cos_theta_max: torch.Tensor):
    cos_t = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_t = m.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * u[..., 1]
    return m.spherical_direction(sin_t, cos_t, phi)


def uniform_cone_pdf(cos_theta_max: torch.Tensor):
    return m.safe_div(torch.ones_like(cos_theta_max),
                      2.0 * math.pi * (1.0 - cos_theta_max))


def uniform_triangle(u: torch.Tensor):
    """Barycentric (b0, b1) uniform over a triangle (sqrt warp)."""
    su0 = m.safe_sqrt(u[..., 0])
    b0 = 1.0 - su0
    b1 = u[..., 1] * su0
    return torch.stack([b0, b1], dim=-1)


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return m.safe_div(nf * f_pdf, nf * f_pdf + ng * g_pdf)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return m.safe_div(f * f, f * f + g * g)
