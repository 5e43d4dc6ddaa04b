"""Texture atlas: host build and sampling (counterpart of
``mcrt_tpu/scene/textures.py``).

Every texture and its mip chain live in one transposed ``(4, TEXELS)``
uint8 buffer with a descriptor row per [mip level, texture], so a fetch is
a gather; nearest, bilinear and trilinear fetches with four wrap modes.
All formats are RGBA8.  ``AtlasBuilder`` is the JAX package's numpy code,
so both packages build identical tables.  ``load_texture_image`` reads a
texture file for it; PNG is decoded here with the standard library
(``zlib`` and ``struct``), so the same bytes come out on every machine,
whether or not it has an imaging library.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from .scene import TextureAtlas

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2
WRAP_BORDER = 3

MAX_MIPS = 12


class AtlasBuilder:
    """Host-side atlas packer."""

    def __init__(self, build_mips: bool = True):
        self.build_mips = build_mips
        self._texels: list[np.ndarray] = []  # (h*w, 4) u8 chunks
        self._descs: list[tuple] = []  # (offset, w, h, mips, wrap)
        self._mip_table: list[np.ndarray] = []  # (MAX_MIPS, 3) per texture
        self._off = 0

    def add(self, image: np.ndarray, wrap: int = WRAP_REPEAT) -> int:
        """image: (H, W, 3|4) uint8 or float in [0,1].  Returns the texture
        id."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        h, w = img.shape[:2]
        levels = [img]
        if self.build_mips:
            cur = img.astype(np.float32)
            while min(cur.shape[0], cur.shape[1]) > 1 and len(levels) < MAX_MIPS:
                hh = max(1, cur.shape[0] // 2)
                ww = max(1, cur.shape[1] // 2)
                cur = cur[: hh * 2, : ww * 2].reshape(hh, 2, ww, 2, 4).mean((1, 3))
                levels.append((cur + 0.5).astype(np.uint8))
        mip_rows = np.zeros((MAX_MIPS, 3), np.int32)
        base_off = self._off
        for li, lv in enumerate(levels):
            lh, lw = lv.shape[:2]
            mip_rows[li] = (self._off, lw, lh)
            self._texels.append(lv.reshape(-1, 4))
            self._off += lh * lw
        for li in range(len(levels), MAX_MIPS):
            mip_rows[li] = mip_rows[len(levels) - 1]  # clamp to the last level
        tid = len(self._descs)
        self._descs.append((base_off, w, h, len(levels), wrap))
        self._mip_table.append(mip_rows)
        return tid

    def build(self) -> TextureAtlas:
        """The atlas as host (CPU) tensors; ``build_scene`` moves it."""
        if not self._descs:
            return TextureAtlas.empty()
        data = np.concatenate(self._texels, axis=0)  # (TEXELS, 4) u8
        descs = np.asarray(self._descs, np.int32)
        mips = np.stack(self._mip_table)  # (T, MAX_MIPS, 3)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        return TextureAtlas(data=t(data.T), offset=t(mips[:, :, 0].T),
                            width=t(mips[:, :, 1].T), height=t(mips[:, :, 2].T),
                            mips=t(descs[:, 3]), wrap=t(descs[:, 4]))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type (grey, RGB, RGBA) -> samples a pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, stride) uint8 scanlines from PNG's filtered stream: each
    line is a filter-type byte (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    and ``stride`` bytes filtered against the line before and the pixel
    ``bpp`` bytes to the left."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    lines = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros((stride,), np.uint8)
    for y in range(height):
        kind, cur = int(lines[y, 0]), lines[y, 1:]
        if kind == 0:
            row = cur.copy()
        elif kind == 1:  # Sub: a running sum, modulo 256, of each byte lane
            lanes = np.zeros((-(-stride // bpp) * bpp,), np.int64)
            lanes[:stride] = cur
            row = (np.cumsum(lanes.reshape(-1, bpp), axis=0) % 256).astype(np.uint8)
            row = row.reshape(-1)[:stride]
        elif kind == 2:  # Up
            row = (cur.astype(np.int64) + prior).astype(np.uint8)
        elif kind in (3, 4):  # Average, Paeth: left to right
            r, up = bytearray(stride), prior.tobytes()
            for i, v in enumerate(cur.tobytes()):
                a = r[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                pred = (a + up[i]) >> 1 if kind == 3 else _paeth(a, up[i], c)
                r[i] = (v + pred) & 0xFF
            row = np.frombuffer(bytes(r), np.uint8)
        else:
            raise ValueError(f"PNG scanline {y} has unknown filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of an 8-bit, non-interlaced grey, RGB or RGBA
    PNG, top row first, as ``PIL.Image.convert("RGBA")`` gives it (grey
    replicated, alpha 255 where the file has none).  Anything else raises
    ``ValueError``."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        pos += 12 + length  # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or image data")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace} (8-bit grey, RGB or RGBA, non-interlaced)")
    ch = _PNG_CHANNELS[colour]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    px = px.reshape(height, width, ch)
    if colour == 6:
        return px
    rgb = np.repeat(px, 3, axis=-1) if colour == 0 else px
    return np.concatenate([rgb, np.full((height, width, 1), 255, np.uint8)], axis=-1)


def load_texture_image(path: str, srgb: bool = False) -> np.ndarray | None:
    """An image file as an (H, W, 4) uint8 RGBA array for
    ``AtlasBuilder.add``, rows flipped so OBJ's bottom-up ``vt`` lands on
    row 0.  ``srgb=True`` linearizes the colour channels (``map_Kd`` colour
    maps are authored in sRGB; radiance math is linear).  A missing file
    gives None (the material then keeps its constant colour, as in the JAX
    package); a file that is not a PNG this decoder reads raises."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    arr = np.flipud(arr).copy()
    if srgb:
        lin = (arr[..., :3].astype(np.float32) / 255.0) ** 2.2
        arr = np.concatenate([(lin * 255.0 + 0.5).astype(np.uint8), arr[..., 3:]], axis=-1)
    return arr


def _wrap_coord(x: torch.Tensor, n: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """Wrap mode applied to integer texel coordinates.  ``jnp.mod`` is a
    floor modulo, so it becomes ``torch.remainder`` (not ``fmod``): a
    negative coordinate wraps to the far edge."""
    rep = torch.remainder(x, n)
    clmp = torch.minimum(torch.maximum(x, torch.zeros_like(n)), n - 1)
    period = torch.clamp_min(2 * n, 1)
    mx = torch.remainder(x, period)
    mir = torch.where(mx >= n, period - 1 - mx, mx)
    # border is masked by the caller (texels outside the image are black)
    return torch.where(mode == WRAP_REPEAT, rep,
                       torch.where(mode == WRAP_CLAMP, clmp,
                                   torch.where(mode == WRAP_MIRROR, mir, clmp)))


def _fetch_texel(atlas: TextureAtlas, off, w, h, x, y, mode) -> torch.Tensor:
    """(4, N) texels in [0, 1] at integer coordinates: the float texels
    ``data_f`` where the atlas has them (differentiable), else the u8
    texels scaled."""
    xin = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    idx = (off + _wrap_coord(y, h, mode) * w + _wrap_coord(x, w, mode)).long()
    if atlas.data_f is not None:
        texel = atlas.data_f.index_select(1, idx)  # backward: index_add_ (take_clip)
    else:
        texel = atlas.data[:, idx].to(torch.float32) / 255.0
    border = (mode == WRAP_BORDER) & ~xin
    return torch.where(border[None, :], 0.0, texel)


def _bilinear(atlas: TextureAtlas, tex: torch.Tensor, level: torch.Tensor,
              uv: torch.Tensor) -> torch.Tensor:
    """(4, N) bilinear fetch at integer mip ``level``."""
    t = tex.clamp_min(0)
    flat = (level * atlas.offset.shape[1] + t).long()  # linearized [level, tex]
    off = atlas.offset.reshape(-1)[flat]
    w = atlas.width.reshape(-1)[flat]
    h = atlas.height.reshape(-1)[flat]
    mode = atlas.wrap[t.long()]
    fx = uv[:, 0] * w.to(torch.float32) - 0.5
    fy = uv[:, 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    ax = (fx - x0.to(torch.float32))[None, :]
    ay = (fy - y0.to(torch.float32))[None, :]
    c00 = _fetch_texel(atlas, off, w, h, x0, y0, mode)
    c10 = _fetch_texel(atlas, off, w, h, x0 + 1, y0, mode)
    c01 = _fetch_texel(atlas, off, w, h, x0, y0 + 1, mode)
    c11 = _fetch_texel(atlas, off, w, h, x0 + 1, y0 + 1, mode)
    return (c00 * (1 - ax) * (1 - ay) + c10 * ax * (1 - ay)
            + c01 * (1 - ax) * ay + c11 * ax * ay)


def compute_lod(atlas: TextureAtlas, tex: torch.Tensor, duvdx: torch.Tensor,
                duvdy: torch.Tensor) -> torch.Tensor:
    """Mip LOD from the uv screen footprint."""
    t = tex.clamp_min(0).long()
    w = atlas.width[0][t].to(torch.float32)
    h = atlas.height[0][t].to(torch.float32)
    fx = torch.maximum(torch.abs(duvdx[:, 0]) * w, torch.abs(duvdx[:, 1]) * h)
    fy = torch.maximum(torch.abs(duvdy[:, 0]) * w, torch.abs(duvdy[:, 1]) * h)
    width = torch.clamp_min(torch.maximum(fx, fy), 1e-8)
    return torch.clamp_min(torch.log2(width), 0.0)


def sample_texture(atlas: TextureAtlas, tex: torch.Tensor, uv: torch.Tensor,
                   duvdx: torch.Tensor | None = None,
                   duvdy: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 4) trilinear RGBA sample (bilinear from the base level without
    differentials).  Lanes with tex < 0 return ones; callers mask them."""
    n = uv.shape[0]
    if atlas.num == 0:
        return torch.ones((n, 4), dtype=torch.float32, device=uv.device)
    t = tex.clamp_min(0)
    num_mips = atlas.mips[t.long()]
    if duvdx is None or duvdy is None:
        rgba = _bilinear(atlas, tex, torch.zeros_like(t), uv).T
    else:
        lod = torch.minimum(compute_lod(atlas, tex, duvdx, duvdy),
                            (num_mips - 1).to(torch.float32))
        l0 = torch.floor(lod).to(torch.int32)
        l1 = torch.minimum(l0 + 1, num_mips - 1)
        fr = (lod - l0.to(torch.float32))[None, :]
        c0 = _bilinear(atlas, tex, l0.clamp(0, MAX_MIPS - 1), uv)
        c1 = _bilinear(atlas, tex, l1.clamp(0, MAX_MIPS - 1), uv)
        rgba = (c0 * (1 - fr) + c1 * fr).T
    return torch.where((tex >= 0)[:, None], rgba, 1.0)
