"""Extended Reinhard tone mapping and the log-average luminance
(counterpart of ``mcrt_tpu/film/tonemap.py``)."""
from __future__ import annotations

import torch

from ..config import ToneMapConfig
from ..core.math import luminance


def reinhard(image: torch.Tensor, cfg: ToneMapConfig) -> torch.Tensor:
    """Extended Reinhard with white point ``cfg.l_white``; per pixel, keeps
    the hue."""
    lum = torch.clamp_min(luminance(image), 1e-8)
    lw2 = cfg.l_white * cfg.l_white
    ld = lum * (1.0 + lum / lw2) / (1.0 + lum)
    return image * (ld / lum)[..., None]


def log_average_luminance(image: torch.Tensor, delta: float = 1e-4) -> torch.Tensor:
    """exp(mean(log(delta + luminance))), a 0-d tensor."""
    return torch.exp(torch.mean(torch.log(delta + luminance(image))))
