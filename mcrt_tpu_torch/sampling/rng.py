"""Sample streams (counterpart of ``mcrt_tpu/sampling/rng.py``).

A ``SampleStream`` carries (seed, frame, next dimension, pixel ids) and every
draw advances the dimension, so one interface backs both samplers:

- SOBOL: scrambled Sobol', bit-exact with the JAX package.
- RANDOM: uniforms from a ``torch.Generator`` seeded from (seed, frame,
  dim).  It cannot reproduce threefry's bits, so it matches the JAX
  package in distribution only.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import SamplerConfig, SamplerType
from .sobol import sobol_matrices, sobol_sample_scrambled


@dataclass(frozen=True)
class SampleStream:
    """Functional per-wavefront sample stream.  ``pixel`` are global pixel
    ids (for the Sobol scramble), ``index`` is the sample index (frame)."""

    seed: int
    index: int
    dim: int
    pixel: torch.Tensor  # (N,) int32
    scramble: int  # frame-independent Sobol scramble seed
    kind: int  # 0 = random, 1 = sobol
    sobol_mats: torch.Tensor | None = None

    def advance(self, k: int) -> "SampleStream":
        return SampleStream(self.seed, self.index, self.dim + k, self.pixel,
                            self.scramble, self.kind, self.sobol_mats)


def make_stream(cfg: SamplerConfig, frame: int, pixel_ids: torch.Tensor,
                sobol_mats: torch.Tensor | None = None) -> SampleStream:
    kind = 1 if cfg.type == SamplerType.SOBOL else 0
    if kind == 1 and sobol_mats is None:
        sobol_mats = sobol_matrices(pixel_ids.device)
    return SampleStream(
        seed=int(cfg.seed), index=int(frame), dim=0,
        pixel=pixel_ids.to(torch.int32),
        # frame-independent: each pixel walks ONE scrambled sequence
        scramble=(int(cfg.seed) * 2654435761) % (1 << 32),
        kind=kind, sobol_mats=sobol_mats,
    )


def _generator_seed(seed: int, frame: int, dim: int) -> int:
    """Mix (seed, frame, dim) into one 63-bit generator seed (splitmix64)."""
    x = (seed * 0x9E3779B97F4A7C15 + frame * 0xBF58476D1CE4E5B9
         + dim * 0x94D049BB133111EB + 0x2545F4914F6CDD1D) & ((1 << 64) - 1)
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def _random_bits(stream: SampleStream, n_dims: int) -> torch.Tensor:
    dev = stream.pixel.device
    g = torch.Generator(device=dev)
    g.manual_seed(_generator_seed(stream.seed, stream.index, stream.dim))
    return torch.rand((stream.pixel.shape[0], n_dims), generator=g,
                      dtype=torch.float32, device=dev)


def _sobol_bits(stream: SampleStream, n_dims: int) -> torch.Tensor:
    dims = torch.arange(stream.dim, stream.dim + n_dims, dtype=torch.int64,
                        device=stream.pixel.device)
    return sobol_sample_scrambled(stream.sobol_mats, stream.index, dims,
                                  stream.pixel, stream.scramble)


def _draw(stream: SampleStream, n_dims: int):
    u = (_random_bits(stream, n_dims) if stream.kind == 0
         else _sobol_bits(stream, n_dims))
    return u, stream.advance(n_dims)


def next_1d(stream: SampleStream):
    u, s = _draw(stream, 1)
    return u[:, 0], s


def next_2d(stream: SampleStream):
    return _draw(stream, 2)


def next_3d(stream: SampleStream):
    return _draw(stream, 3)
