"""Pixel reconstruction filters (counterpart of ``mcrt_tpu/film/filters.py``):
box, triangle, Gaussian, Mitchell-Netravali, Lanczos-windowed sinc, each
evaluated at an offset from the pixel center in pixel units."""
from __future__ import annotations

import math

import torch

from ..config import FilterConfig, FilterType


def _gaussian_1d(x, alpha, radius):
    # the float32 tail as a Python float: no per-frame copy to the card
    tail = torch.exp(torch.tensor(-alpha * radius * radius, dtype=torch.float32)).item()
    g = torch.exp(-alpha * x * x) - tail
    return torch.clamp_min(g, 0.0)


def _mitchell_1d(x, b, c):
    x = torch.abs(2.0 * x)
    x2 = x * x
    x3 = x2 * x
    inner = ((12.0 - 9.0 * b - 6.0 * c) * x3 + (-18.0 + 12.0 * b + 6.0 * c) * x2
             + (6.0 - 2.0 * b)) * (1.0 / 6.0)
    outer = ((-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2
             + (-12.0 * b - 48.0 * c) * x + (8.0 * b + 24.0 * c)) * (1.0 / 6.0)
    return torch.where(x > 1.0, torch.where(x > 2.0, 0.0, outer), inner)


def _sinc(x):
    x = torch.abs(x)
    px = math.pi * x
    return torch.where(x < 1e-5, 1.0, torch.sin(px) / px)


def _lanczos_1d(x, tau, radius):
    x = torch.abs(x)
    return torch.where(x > radius, 0.0, _sinc(x) * _sinc(x / tau))


def eval_filter(cfg: FilterConfig, offset: torch.Tensor) -> torch.Tensor:
    """Filter weight at ``offset`` (..., 2) pixels from the pixel center."""
    x = offset[..., 0]
    y = offset[..., 1]
    r = cfg.radius
    if cfg.type == FilterType.BOX:
        inside = (torch.abs(x) <= r) & (torch.abs(y) <= r)
        return torch.where(inside, 1.0, 0.0)
    if cfg.type == FilterType.TRIANGLE:
        return torch.clamp_min(r - torch.abs(x), 0.0) * torch.clamp_min(r - torch.abs(y), 0.0)
    if cfg.type == FilterType.GAUSSIAN:
        return (_gaussian_1d(x, cfg.gaussian_alpha, r)
                * _gaussian_1d(y, cfg.gaussian_alpha, r))
    if cfg.type == FilterType.MITCHELL:
        return (_mitchell_1d(x / r, cfg.mitchell_b, cfg.mitchell_c)
                * _mitchell_1d(y / r, cfg.mitchell_b, cfg.mitchell_c))
    if cfg.type == FilterType.LANCZOS:
        return _lanczos_1d(x, cfg.lanczos_tau, r) * _lanczos_1d(y, cfg.lanczos_tau, r)
    raise ValueError(f"unknown filter {cfg.type}")
