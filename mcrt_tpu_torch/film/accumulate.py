"""Progressive filter-weighted accumulation (counterpart of
``mcrt_tpu/film/accumulate.py``): radiance is clamped to ``max_radiance``,
weighted by the reconstruction filter at the frame's sub-pixel jitter and
summed into (weighted, weight) buffers; the image is weighted / weight."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import FilterConfig
from ..core.types import TensorRecord, default_device
from .filters import eval_filter


@dataclass
class Accumulator(TensorRecord):
    weighted: torch.Tensor  # (H, W, 3) filter-weighted radiance sum
    weight: torch.Tensor  # (H, W) filter weight sum
    frame: int  # samples per pixel accumulated so far

    @classmethod
    def zeros(cls, width: int, height: int, device=None):
        """An empty film on ``default_device(device)``."""
        device = default_device(device)
        return cls(
            weighted=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            weight=torch.zeros((height, width), dtype=torch.float32, device=device),
            frame=0,
        )

    def reset(self):
        return Accumulator.zeros(self.weighted.shape[1], self.weighted.shape[0],
                                 self.weighted.device)

    @property
    def image(self) -> torch.Tensor:
        return self.weighted / torch.clamp_min(self.weight, 1e-8)[..., None]


def accumulate(accum: Accumulator, radiance: torch.Tensor, jitter: torch.Tensor,
               cfg: FilterConfig, max_radiance: float = 1000.0) -> Accumulator:
    """Fold one sample of radiance ((H, W, 3) or (H*W, 3)) into the
    accumulator with one filter weight for the frame's jitter."""
    h, w = accum.weight.shape
    radiance = torch.clamp(radiance.reshape(h, w, 3), 0.0, max_radiance)
    fw = eval_filter(cfg, jitter)
    return Accumulator(weighted=accum.weighted + radiance * fw,
                       weight=accum.weight + fw, frame=accum.frame + 1)
