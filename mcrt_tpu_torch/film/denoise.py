"""Bilateral denoiser (counterpart of ``mcrt_tpu/film/denoise.py``): a
spatial and range Gaussian over the (2r+1)^2 neighbourhood, as a loop of
``torch.roll``s over the whole image (wrapping at the borders, as the JAX
package's ``jnp.roll`` does)."""
from __future__ import annotations

import torch

from ..config import DenoiseConfig


def bilateral(image: torch.Tensor, cfg: DenoiseConfig) -> torch.Tensor:
    """(H, W, 3) -> (H, W, 3)."""
    r = cfg.radius
    inv_2ss = 1.0 / (2.0 * cfg.sigma_spatial ** 2)
    inv_2sr = 1.0 / (2.0 * cfg.sigma_range ** 2)
    acc = torch.zeros_like(image)
    wsum = torch.zeros(image.shape[:-1], dtype=image.dtype, device=image.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = torch.roll(image, (dy, dx), dims=(0, 1))
            d2 = torch.sum((shifted - image) ** 2, dim=-1)
            w = torch.exp(-(dx * dx + dy * dy) * inv_2ss - d2 * inv_2sr)
            acc = acc + shifted * w[..., None]
            wsum = wsum + w
    return acc / torch.clamp_min(wsum, 1e-8)[..., None]
