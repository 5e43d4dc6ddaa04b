"""Sample streams: the port's Sobol stream, with one sample index a lane.

A ``SampleStream`` carries (frame of each lane, next dimension, pixel ids)
and every draw advances the dimension.  Only the Sobol sampler is kept:
the benchmark's configurations state it, and a configuration that states
another is refused where the stream is made.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import SamplerConfig, SamplerType
from ..core.types import TensorRecord
from .sobol import sobol_matrices, sobol_sample_scrambled


@dataclass(frozen=True)
class SampleStream(TensorRecord):
    """Functional per-wavefront sample stream.  ``pixel`` are global pixel
    ids (for the Sobol scramble), ``index`` the sample index (frame) of each
    lane."""

    index: torch.Tensor  # (N,) int64
    dim: int
    pixel: torch.Tensor  # (N,) int32
    scramble: int  # frame-independent Sobol scramble seed
    sobol_mats: torch.Tensor

    def advance(self, k: int) -> "SampleStream":
        return dataclasses.replace(self, dim=self.dim + k)


def make_stream(cfg: SamplerConfig, frames: torch.Tensor,
                pixel_ids: torch.Tensor) -> SampleStream:
    if cfg.type != SamplerType.SOBOL:
        raise ValueError(f"the reference draws Sobol samples only, not {cfg.type.value!r}")
    return SampleStream(
        index=frames.to(torch.int64), dim=0, pixel=pixel_ids.to(torch.int32),
        # frame-independent: each pixel walks ONE scrambled sequence
        scramble=(int(cfg.seed) * 2654435761) % (1 << 32),
        sobol_mats=sobol_matrices(pixel_ids.device))


def _draw(stream: SampleStream, n_dims: int):
    dims = torch.arange(stream.dim, stream.dim + n_dims, dtype=torch.int64,
                        device=stream.pixel.device)
    u = sobol_sample_scrambled(stream.sobol_mats, stream.index, dims, stream.pixel,
                               stream.scramble)
    return u, stream.advance(n_dims)


def next_1d(stream: SampleStream):
    u, s = _draw(stream, 1)
    return u[:, 0], s


def next_2d(stream: SampleStream):
    return _draw(stream, 2)


def next_3d(stream: SampleStream):
    return _draw(stream, 3)
