"""The reference's BDPT film at any pixels over any frames.

A BDPT pixel's sample is not a function of its own lane: a t = 1 splat of
any lane's light subpath can land on it.  So the film at the checked
pixels takes two passes over every frame:

1. each checked pixel's own lane: its camera subpath, its light subpath and
   every strategy but t = 1 (``integrators/bdpt.own_radiance``);
2. every lane's light subpath (all W*H of the frame) and its t = 1
   connections to the camera, of which only those whose raster position
   falls on a checked pixel get a shadow ray and a place in the film
   (``integrators/bdpt.splats``).

A pixel's sample is its own lane's radiance plus every splat of its frame
that landed on it, clamped to ``max_radiance`` and weighted by the filter
at the frame's jitter, as the port's ``Renderer`` folds a frame.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera.pinhole import PinholeCamera
from .config import RenderConfig
from .core.types import Rays, device_constant
from .film.filters import eval_filter
from .integrators import bdpt
from .render import frame_jitter
from .sampling import rng

# lanes traced together: checked (pixel, frame) lanes, and light-subpath
# lanes of whole frames, by device type
OWN_CHUNK = {"cuda": 1 << 16, "cpu": 1 << 12}
LIGHT_CHUNK = {"cuda": 1 << 19, "cpu": 1 << 14}


def _own(scene, camera: PinholeCamera, cfg: RenderConfig, pix, fr, query):
    """(L, 3) own-lane radiance of row-major pixels ``pix`` at samples
    ``fr``: the frame's jittered pinhole ray and the pixel's stream."""
    w, h, device = cfg.width, cfg.height, pix.device
    uniq, slot = torch.unique(fr, return_inverse=True)
    jit = torch.as_tensor(frame_jitter(uniq.tolist()), device=device)[slot]
    u = ((pix % w).to(torch.float32) + 0.5) / w
    v = ((pix // w).to(torch.float32) + 0.5) / h
    uv = torch.stack([u, v], dim=-1) + jit / device_constant((float(w), float(h)), device)
    o, d = camera.generate_rays(uv)
    return bdpt.own_radiance(scene, camera, Rays.make(o, d), rng.make_stream(cfg.sampler, fr, pix),
                             cfg.integrator, query.intersect, query.occluded)


def film_at_bdpt(scene, camera: PinholeCamera, cfg: RenderConfig, pixels: torch.Tensor, frames,
                 query) -> torch.Tensor:
    """(P, 3) progressive BDPT image at row-major ``pixels`` (P,) after the
    host sample indices ``frames`` (N,), folded in that order."""
    # float32 throughout: no product may run in TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, h, device = cfg.width, cfg.height, pixels.device
    n, p, n_pix = len(frames), pixels.shape[0], cfg.width * cfg.height
    fr = torch.as_tensor(np.asarray(frames, np.int64), device=device)
    pix = pixels.long()
    # sample (pixel i, frame k) is row i * n + k
    row_of = torch.full((n_pix,), -1, dtype=torch.int64, device=device).index_put(
        (pix,), torch.arange(p, device=device))
    keep = row_of >= 0

    lanes_p, lanes_f = pix.repeat_interleave(n), fr.repeat(p)
    step = OWN_CHUNK[device.type]
    rad = torch.cat([_own(scene, camera, cfg, lanes_p[s:s + step], lanes_f[s:s + step], query)
                     for s in range(0, p * n, step)])

    step = LIGHT_CHUNK[device.type]
    for s in range(0, n * n_pix, step):
        lane = torch.arange(s, min(n * n_pix, s + step), device=device)
        k, q = lane // n_pix, lane % n_pix
        stream = bdpt.skip_camera_walk(rng.make_stream(cfg.sampler, fr[k], q), cfg.integrator)
        for pixel, vis, contrib in bdpt.splats(scene, camera, stream, cfg.integrator,
                                               query.intersect, query.occluded, lane.shape[0],
                                               w, h, keep):
            rad = rad.index_add(0, row_of[pixel].clamp_min(0) * n + k,
                                torch.where(vis[..., None], contrib, 0.0))

    rad = torch.clamp(rad, 0.0, cfg.integrator.max_radiance).reshape(p, n, 3)
    fw = eval_filter(cfg.filter, torch.as_tensor(frame_jitter(frames), device=device))
    weighted = torch.zeros_like(rad[:, 0])
    weight = torch.zeros((), dtype=torch.float32, device=device)
    for k in range(n):
        weighted = weighted + rad[:, k] * fw[k]
        weight = weight + fw[k]
    return weighted / torch.clamp_min(weight, 1e-8)
