"""Sample streams (counterpart of ``mcrt_tpu/sampling/rng.py``).

A ``SampleStream`` carries (seed, frame, next dimension, pixel ids) and every
draw advances the dimension, so one interface backs both samplers:

- SOBOL: scrambled Sobol', bit-exact with the JAX package.
- RANDOM: ``jax.random.uniform`` under the partitionable threefry, bit-exact
  with the JAX package.  The key, ``fold_in(fold_in(PRNGKey(seed), frame),
  dim)``, is computed on the host in Python integers (the stream's seed,
  frame and dimension are Python ints), so a draw adds no device constant
  and no host sync; the counters and the 20 threefry rounds run on the
  pixels' device in int64 with explicit 32-bit masks, as ``sobol.py`` does
  its uint32 arithmetic.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import SamplerConfig, SamplerType
from ..core.types import TensorRecord
from .sobol import M32, sobol_matrices, sobol_sample_scrambled


@dataclass(frozen=True)
class SampleStream(TensorRecord):
    """Functional per-wavefront sample stream.  ``pixel`` are global pixel
    ids (for the Sobol scramble), ``index`` is the sample index (frame).
    ``row0`` is the wavefront row of the first lane: a rays-sharded render
    traces rows ``row0 ..`` of the full wavefront, and RANDOM's counters
    run over the full wavefront's rows, as the JAX package's global
    arrays do under a mesh."""

    seed: int
    index: int
    dim: int
    pixel: torch.Tensor  # (N,) int32
    scramble: int  # frame-independent Sobol scramble seed
    kind: int  # 0 = random, 1 = sobol
    sobol_mats: torch.Tensor | None = None
    row0: int = 0

    def advance(self, k: int) -> "SampleStream":
        return dataclasses.replace(self, dim=self.dim + k)


def make_stream(cfg: SamplerConfig, frame: int, pixel_ids: torch.Tensor,
                sobol_mats: torch.Tensor | None = None, row0: int = 0) -> SampleStream:
    kind = 1 if cfg.type == SamplerType.SOBOL else 0
    if kind == 1 and sobol_mats is None:
        sobol_mats = sobol_matrices(pixel_ids.device)
    return SampleStream(
        seed=int(cfg.seed), index=int(frame), dim=0,
        pixel=pixel_ids.to(torch.int32),
        # frame-independent: each pixel walks ONE scrambled sequence
        scramble=(int(cfg.seed) * 2654435761) % (1 << 32),
        kind=kind, sobol_mats=sobol_mats, row0=int(row0),
    )


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under the
    key ``(k0, k1)``, as ``jax.random``'s threefry.  The words are Python
    ints or int64 tensors holding uint32 values; the key is Python ints."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & M32  # one add of a host int
    return x0, x1


def random_key(seed: int, frame: int, dim: int) -> tuple[int, int]:
    """``fold_in(fold_in(PRNGKey(seed), frame), dim)`` on the host:
    ``PRNGKey(s)`` is (0, s) and ``fold_in(k, x)`` is ``threefry2x32(k,
    (0, x))``, every word a uint32."""
    key = (0, seed & M32)
    for data in (frame, dim):
        key = _threefry2x32(key, 0, data & M32)
    return key


def _random_bits(stream: SampleStream, n_dims: int) -> torch.Tensor:
    """(N, n_dims) uniforms in [0, 1), equal to ``jax.random.uniform`` of
    the stream's key: threefry of each element's row-major counter (high,
    low word), the xor of the two output words, its top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    key = random_key(stream.seed, stream.index, stream.dim)
    n = stream.pixel.shape[0]
    i = torch.arange(stream.row0 * n_dims, (stream.row0 + n) * n_dims, dtype=torch.int64,
                     device=stream.pixel.device)
    y0, y1 = _threefry2x32(key, i >> 32, i & M32)
    mant = ((y0 ^ y1) >> 9) | 0x3F800000
    return (mant.to(torch.int32).view(torch.float32) - 1.0).reshape(n, n_dims)


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
