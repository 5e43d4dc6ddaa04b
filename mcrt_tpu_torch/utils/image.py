"""Image IO and comparison metrics (counterpart of
``mcrt_tpu/utils/image.py``).

PNGs are written with ``zlib`` and ``struct`` and read with the port's own
decoder (``scene/textures.py: decode_png``): no imaging library is needed.
Images are numpy arrays or tensors; rows of a rendered image are stored
bottom-up (film v = 0 at the bottom), so output flips them by default.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _numpy(img) -> np.ndarray:
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def to_srgb_u8(img, flip_vertical: bool = True) -> np.ndarray:
    """Linear HDR (H, W, 3) -> display uint8 with gamma 2.2, in float32 as
    the JAX package computes it."""
    x = np.asarray(_numpy(img), np.float32)
    if flip_vertical:
        x = x[::-1]
    x = np.clip(x, 0.0, 1.0) ** (1.0 / 2.2)
    return (x * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG (filter type 0 on every line) of (H, W, 3) uint8."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, ch = rgb.shape
    if ch != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    lines = np.zeros((h, 1 + 3 * w), np.uint8)
    lines[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(lines.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img, flip_vertical: bool = True):
    """Write linear HDR (H, W, 3) as an sRGB-ish (gamma 2.2) PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(to_srgb_u8(img, flip_vertical)))


def read_png(path: str) -> np.ndarray:
    """Float32 in [0, 1] with the file's channels: (H, W) grey, (H, W, 3)
    RGB or (H, W, 4) RGBA, top row first."""
    from ..scene.textures import decode_png

    with open(path, "rb") as f:
        data = f.read()
    rgba = decode_png(data)
    colour = data[25]  # the IHDR colour type (decode_png has checked the header)
    px = {0: rgba[..., 0], 2: rgba[..., :3]}.get(colour, rgba)
    return px.astype(np.float32) / 255.0


def mse(a, b) -> float:
    return float(np.mean((_numpy(a) - _numpy(b)) ** 2))


def relative_mse(a, ref, eps: float = 1e-2) -> float:
    """MSE normalized by the reference's brightness."""
    a, ref = _numpy(a), _numpy(ref)
    return float(np.mean((a - ref) ** 2 / (ref * ref + eps)))
