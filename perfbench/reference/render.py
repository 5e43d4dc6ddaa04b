"""The reference's samples: any (pixel, frame) lanes in one wavefront.

The port's renderer traces one frame of every pixel at a time.  Each
pixel's sample depends only on its pixel, its frame and the scene, so the
reference traces just the lanes a check needs, frames mixed: the same
frame-wide Halton jitter, pinhole ray, Sobol stream, path integrator and
film arithmetic, with the reference's own queries (``query.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .camera.pinhole import PinholeCamera
from .config import RenderConfig
from .core.types import Rays, device_constant
from .film.filters import eval_filter
from .integrators import path
from .sampling import rng

LANE_CHUNK = 1 << 17  # lanes traced together


def _radical_inverse(i: int, base: int) -> np.float32:
    """Halton radical inverse in float32, in the port's order of operations
    (32 digits, a multiply by the float32 reciprocal of the base)."""
    val, inv = np.float32(0.0), np.float32(1.0)
    recip = np.float32(1.0) / np.float32(base)
    for _ in range(32):
        d = i % base
        i //= base
        inv = np.float32(inv * recip)
        val = np.float32(val + np.float32(d) * inv)
    return val


def frame_jitter(frames) -> np.ndarray:
    """(N, 2) float32 sub-pixel offsets in [-0.5, 0.5) of the frames."""
    half = np.float32(0.5)
    return np.asarray([[_radical_inverse(int(f) + 1, 2) - half,
                        _radical_inverse(int(f) + 1, 3) - half] for f in frames], np.float32)


def render_lanes(scene, camera: PinholeCamera, cfg: RenderConfig, pixels: torch.Tensor,
                 frames: torch.Tensor, query) -> torch.Tensor:
    """(L, 3) radiance of row-major ``pixels`` (L,) at sample ``frames``
    (L,), unclamped, as the port's ``render_sample`` gives each lane."""
    w, h = cfg.width, cfg.height
    device = pixels.device
    out = []
    for s in range(0, pixels.shape[0], LANE_CHUNK):
        pix, fr = pixels[s:s + LANE_CHUNK].long(), frames[s:s + LANE_CHUNK].long()
        uniq, slot = torch.unique(fr, return_inverse=True)
        jit = torch.as_tensor(frame_jitter(uniq.tolist()), device=device)[slot]
        u = ((pix % w).to(torch.float32) + 0.5) / w
        v = ((pix // w).to(torch.float32) + 0.5) / h
        uv = torch.stack([u, v], dim=-1) + jit / device_constant((float(w), float(h)), device)
        o, d = camera.generate_rays(uv)
        diff = camera.generate_ray_differentials(uv, w, h)
        stream = rng.make_stream(cfg.sampler, fr, pix)
        out.append(path.trace(scene, Rays.make(o, d), stream, cfg.integrator,
                              query.intersect, query.occluded, diff=diff))
    return torch.cat(out)


def film_at(scene, camera, cfg: RenderConfig, pixels: torch.Tensor, frames, query
            ) -> torch.Tensor:
    """(P, 3) progressive image at ``pixels`` (P,) after the host sample
    indices ``frames`` (N,), folded in that order: each sample clamped to
    ``max_radiance`` and weighted by the filter at its frame's jitter, the
    weighted sum over the weight sum, as the port's ``Accumulator``."""
    n, device = len(frames), pixels.device
    fr = torch.as_tensor(np.asarray(frames, np.int64), device=device)
    lanes_f = fr.repeat(pixels.shape[0])
    lanes_p = pixels.long().repeat_interleave(n)
    rad = render_lanes(scene, camera, cfg, lanes_p, lanes_f, query).reshape(-1, n, 3)
    rad = torch.clamp(rad, 0.0, cfg.integrator.max_radiance)
    fw = eval_filter(cfg.filter, torch.as_tensor(frame_jitter(frames), device=device))
    weighted = torch.zeros_like(rad[:, 0])
    weight = torch.zeros((), dtype=torch.float32, device=device)
    for k in range(n):
        weighted = weighted + rad[:, k] * fw[k]
        weight = weight + fw[k]
    return weighted / torch.clamp_min(weight, 1e-8)


def mean_at(scene, camera, cfg: RenderConfig, pixels: torch.Tensor, frames, query
            ) -> torch.Tensor:
    """(P, 3) mean radiance at ``pixels`` over the sample indices
    ``frames``, unclamped and unweighted, as the port's
    ``render_spp_batch`` averages its samples."""
    n, device = len(frames), pixels.device
    fr = torch.as_tensor(np.asarray(frames, np.int64), device=device)
    rad = render_lanes(scene, camera, cfg, pixels.long().repeat_interleave(n),
                       fr.repeat(pixels.shape[0]), query)
    return rad.reshape(-1, n, 3).mean(1)
