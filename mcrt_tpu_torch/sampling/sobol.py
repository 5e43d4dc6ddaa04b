"""Sobol' low-discrepancy sampler (counterpart of ``mcrt_tpu/sampling/sobol.py``).

Bit-exact with the JAX package: the same Joe-Kuo direction numbers (a copy
of ``_sobol_mats.npy`` ships beside this file), the same XOR fold over the
sample index and the same per-(pixel, dimension) ``_hash2`` digit scramble.
The fold depends only on the sample index and the dimension, so it is
taken once a sample on the host for every dimension (``fold_table``) and a
draw gathers its dimensions from that table: no device op depends on the
sample index, and a frame's draws launch the same work whatever it is.
torch's ``uint32`` lacks most bitwise ops, so uint32 arithmetic runs in
int64 and every result is masked back to 32 bits; products are split into
16-bit halves so that no intermediate overflows int64.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..core.types import default_device, from_host

_MATS_PATH = os.path.join(os.path.dirname(__file__), "_sobol_mats.npy")
M32 = 0xFFFFFFFF


def sobol_matrices(device=None) -> torch.Tensor:
    """(D, 32) direction numbers as int64 holding uint32 values, on
    ``default_device(device)`` (loaded once per device: the same tensor for
    ``"cuda"`` and the current card's index)."""
    device = default_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _matrices(device)


def require_shipped(mats: torch.Tensor):
    """Raise ``ValueError`` unless ``mats`` is ``sobol_matrices()`` of its
    device: draws fold the shipped direction numbers on the host
    (``fold_table``), and a caller's own would have to be read back from
    the card, a sync."""
    if mats is not sobol_matrices(mats.device):
        raise ValueError("Sobol draws use the shipped direction numbers: pass "
                         "sobol_matrices(device) or nothing")


@functools.lru_cache(maxsize=4)
def _matrices(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_host_matrices().copy()).to(device)


@functools.lru_cache(maxsize=1)
def _host_matrices() -> np.ndarray:
    mats = np.load(_MATS_PATH).astype(np.int64)
    mats.flags.writeable = False
    return mats


def fold_table(index: int, device=None) -> torch.Tensor:
    """(D,) int64 holding uint32 values, on ``default_device(device)``: for
    every dimension d, the XOR of the shipped direction numbers
    ``mats[d, b]`` over the set bits b of the sample index, taken mod 2^32.
    It is computed on the host, and copied to a card without making the
    host wait (``from_host``)."""
    mats = _host_matrices()
    idx = int(index) & M32
    fold = np.bitwise_xor.reduce(mats[:, [b for b in range(32) if (idx >> b) & 1]], axis=1)
    return from_host(torch.from_numpy(fold), default_device(device))


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant c < 2^32."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash2(a: torch.Tensor, b) -> torch.Tensor:
    """Mix two uint32s (xxhash-style constants), as ``mcrt_tpu``'s ``_hash2``."""
    x = (mul32(a & M32, 0x9E3779B1) + b) & M32
    x = x ^ (x >> 15)
    x = mul32(x, 0x85EBCA77)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE3D)
    x = x ^ (x >> 16)
    return x


def sobol_scrambled(fold: torch.Tensor, dims: torch.Tensor, pixel: torch.Tensor,
                    scramble_seed: int) -> torch.Tensor:
    """(N, k) scrambled Sobol samples in [0, 1): dimensions ``dims`` (k,)
    of the sample whose ``fold_table`` is ``fold`` (dimensions past its end
    take its last), for pixels ``pixel`` (N,)."""
    x = fold[dims.clamp(0, fold.shape[0] - 1)]  # (k,)
    scr = hash2(
        (mul32(pixel.to(torch.int64)[:, None] & M32, 0x632BE59B)
         + dims.to(torch.int64)[None, :]) & M32,
        int(scramble_seed) & M32,
    )  # (N, k)
    # Python-float constants: a 0-d tensor copied to the card here would
    # make the host wait for the stream on every draw
    v = (x[None, :] ^ scr).to(torch.float32)
    return torch.clamp(v * 2.3283064365386963e-10, max=1.0 - 1e-7)


def sobol_sample_scrambled(mats: torch.Tensor, index: int, dims: torch.Tensor,
                           pixel: torch.Tensor, scramble_seed: int) -> torch.Tensor:
    """(N, k) scrambled Sobol samples in [0, 1): sample ``index`` of
    dimensions ``dims`` (k,) for pixels ``pixel`` (N,).  The JAX package's
    entry point: ``mats`` must be ``sobol_matrices()`` (``require_shipped``),
    whose host copy gives the fold (``fold_table``)."""
    require_shipped(mats)
    fold = fold_table(index, dims.device)
    return sobol_scrambled(fold, dims, pixel, scramble_seed)
