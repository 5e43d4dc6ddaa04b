"""OBJ import in the port (``mcrt_tpu_torch/scene/objloader.py``,
``scene_from_obj`` and ``load_texture_image``) against the JAX package,
on the committed fixture ``tests/assets/texbox.obj`` (a checkerboard
``map_Kd`` and a dent ``map_bump`` normal map, both 64x64 8-bit RGB PNGs).

The loaders are the same numpy code on the same bytes, so meshes,
materials, scene tables and decoded texels must be equal.  The PNG decoder
is the port's own (``zlib`` and ``struct``): its arrays must equal PIL's
where PIL is installed.  Renders: the committed golden
``tests/goldens/texbox.npz`` within its own bound of 0.02 mean-relative
error through ``AccelType.AUTO``, and at least 99% of pixels within rtol
1e-3 / atol 1e-4 of the JAX package's render (a flipped decision changes a
whole pixel).
"""
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import mcrt_tpu
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.scene import objloader as jobj
from mcrt_tpu.scene import textures as jtex
from mcrt_tpu_torch import Renderer
from mcrt_tpu_torch.config import AccelType, IntegratorConfig, RenderConfig
from mcrt_tpu_torch.runtime import native as tnative
from mcrt_tpu_torch.scene import objloader as tobj
from mcrt_tpu_torch.scene import textures as ttex
from mcrt_tpu_torch.scene.builders import scene_from_obj
from mcrt_tpu_torch.scene.scene import TEX_DIFFUSE, TEX_NORMAL
from tests.test_torch_blocked import port_scene
from tests.test_torch_render import _camera

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
TEXBOX = os.path.join(ASSETS, "texbox.obj")
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "texbox.npz")
CAMERA = dict(eye=(0.0, 1.0, 2.5), target=(0.0, 0.8, 0.0), fov_deg=50.0)
PNGS = ("texdiff.png", "texnorm.png")
MIN_AGREE = 0.99


@pytest.fixture(scope="module")
def texbox():
    return scene_from_obj(TEXBOX, camera_kw=CAMERA, device="cpu")


@pytest.fixture(scope="module")
def jax_texbox():
    return jb.scene_from_obj(TEXBOX, camera_kw=CAMERA)


def _assert_meshes_equal(t, j):
    for k in ("positions", "normals", "uvs", "indices", "face_material", "emissive_faces"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert [vars(m) for m in t.materials] == [vars(m) for m in j.materials]


@pytest.mark.parametrize("parser", ["native", "python"])
def test_load_obj_equals_jax(parser, monkeypatch):
    """``load_obj`` through the native parser and through the Python line
    parser: the mesh and materials of the JAX package's loader."""
    if parser == "python":
        monkeypatch.setattr(tnative, "parse_obj_native", lambda path: None)
        monkeypatch.setattr(jobj, "_load_obj_native", lambda path: None)
    else:
        assert tnative.parse_obj_native(TEXBOX) is not None
    t, j = tobj.load_obj(TEXBOX), jobj.load_obj(TEXBOX)
    _assert_meshes_equal(t, j)
    assert len(t.indices) == 6 and [m.name for m in t.materials] == ["floortex", "wall", "lamp"]
    uber = [m.to_uber() for m in t.materials]
    for a, b in zip(uber, [m.to_uber() for m in j.materials]):
        for k, v in vars(b).items():
            assert np.array_equal(getattr(a, k), v), k


@pytest.mark.parametrize("parser", ["native", "python"])
def test_obj_polygons_negative_indices_and_missing_normals(parser, tmp_path, monkeypatch):
    """A quad (fan triangulation), negative indices, ``v//vn``, faces
    without normals and no material load as the JAX package loads them."""
    if parser == "python":
        monkeypatch.setattr(tnative, "parse_obj_native", lambda path: None)
        monkeypatch.setattr(jobj, "_load_obj_native", lambda path: None)
    obj = tmp_path / "poly.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nvn 0 0 1\n"
                   "f 1 2 3 4\nf -1 -4 -3\nf 1//1 3//1 5//1\n")
    t = tobj.load_obj(str(obj))
    _assert_meshes_equal(t, jobj.load_obj(str(obj)))
    assert len(t.indices) == 4 and np.isfinite(t.normals).all()
    assert tobj.parse_mtl(str(tmp_path / "absent.mtl")) == {}


def test_scene_from_obj_equals_jax(texbox, jax_texbox):
    """``scene_from_obj(texbox)``: geometry, materials and their texture
    slots, lights and the atlas equal to the JAX package's scene."""
    scene, cam = texbox
    crossed = port_scene(jax_texbox[0])
    for group in ("geometry", "shapes", "materials", "lights", "textures"):
        for field, v in vars(getattr(crossed, group)).items():
            if isinstance(v, torch.Tensor):
                torch.testing.assert_close(getattr(getattr(scene, group), field), v,
                                           rtol=0, atol=0, msg=f"{group}.{field}")
    torch.testing.assert_close(scene.center, crossed.center, rtol=0, atol=0)
    for field, v in vars(_camera(jax_texbox[1])).items():
        torch.testing.assert_close(getattr(cam, field), v, rtol=1e-6, atol=1e-6)


def test_atlas_and_slots_wired(texbox):
    scene, _ = texbox
    assert int(scene.textures.num) == 2
    tex = scene.materials.tex.numpy()
    assert tex[0, TEX_DIFFUSE] == 0  # floortex -> map_Kd
    assert tex[0, TEX_NORMAL] == 1  # floortex -> map_bump
    assert (tex[1:] == -1).all()  # wall and lamp untextured
    assert scene.textures.data.shape[1] >= 2 * 64 * 64


def test_map_kd_is_srgb_linearized(texbox):
    """The checker's dark tile is 0.2 in sRGB: the atlas stores 0.2^2.2."""
    scene, _ = texbox
    base = scene.textures.data[:3, :64 * 64].numpy().astype(np.float32) / 255.0
    assert np.abs(base[0] - 0.2 ** 2.2).min() < 2.0 / 255.0
    assert np.abs(base[0] - 0.2).min() > 2.0 / 255.0


@pytest.mark.parametrize("name", PNGS)
@pytest.mark.parametrize("srgb", [False, True])
def test_load_texture_image_equals_jax(name, srgb):
    """The port's decode of the fixtures equals the JAX package's
    ``load_texture_image`` (PIL's decode, flipped and linearized alike)."""
    pytest.importorskip("PIL")
    path = os.path.join(ASSETS, name)
    a, b = ttex.load_texture_image(path, srgb=srgb), jtex.load_texture_image(path, srgb=srgb)
    assert a.shape == (64, 64, 4) and a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("name", PNGS)
def test_png_decoder_equals_pil(name):
    pil = pytest.importorskip("PIL.Image")
    path = os.path.join(ASSETS, name)
    with open(path, "rb") as f:
        ours = ttex.decode_png(f.read())
    with pil.open(path) as im:
        assert np.array_equal(ours, np.asarray(im.convert("RGBA"), np.uint8))


def _png(pixels: np.ndarray, colour: int, filters) -> bytes:
    """An 8-bit PNG of ``pixels`` (H, W, channels) whose scanline y is
    filtered with ``filters[y % len(filters)]`` (the encoder's side of the
    five filter types), split over two IDAT chunks."""
    h, w = pixels.shape[:2]
    bpp = pixels.shape[2]
    rows = pixels.reshape(h, -1).astype(np.int64)
    raw = bytearray()
    prior = np.zeros_like(rows[0])
    for y in range(h):
        kind, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw.append(kind)
        raw.extend(((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = zlib.compress(bytes(raw))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
    half = len(data) // 2
    return out + chunk(b"IDAT", data[:half]) + chunk(b"IDAT", data[half:]) + chunk(b"IEND", b"")


@pytest.mark.parametrize("colour, channels", [(0, 1), (2, 3), (6, 4)])
def test_png_decoder_undoes_every_filter(colour, channels, tmp_path):
    """Random 8-bit grey, RGB and RGBA images, their rows filtered with all
    five filter types in turn, decode to the RGBA that
    ``PIL.Image.convert("RGBA")`` gives (grey replicated, alpha 255 where
    the file has none)."""
    rng = np.random.default_rng(colour)
    h, w = 11, 7
    px = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    data = _png(px, colour, [0, 1, 2, 3, 4])
    got = ttex.decode_png(data)
    rgb = np.repeat(px, 3, -1) if colour == 0 else px[..., :3]
    alpha = px[..., 3:] if colour == 6 else np.full((h, w, 1), 255, np.uint8)
    assert got.shape == (h, w, 4) and np.array_equal(got, np.concatenate([rgb, alpha], -1))
    try:
        from PIL import Image
    except ImportError:
        return
    path = tmp_path / "x.png"
    path.write_bytes(data)
    with Image.open(path) as im:
        assert np.array_equal(got, np.asarray(im.convert("RGBA"), np.uint8))


def test_unreadable_texture_raises_and_missing_gives_none(tmp_path):
    """A file the decoder cannot read raises (it does not degrade to the
    constant colour); a missing file gives None."""
    assert ttex.load_texture_image(str(tmp_path / "absent.png")) is None
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"GIF89a not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        ttex.load_texture_image(str(bad))
    interlaced = _png(np.zeros((2, 2, 3), np.uint8), 2, [0]).replace(
        struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0), struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1))
    bad.write_bytes(interlaced)
    with pytest.raises(ValueError, match="interlace"):
        ttex.load_texture_image(str(bad))
    grey_alpha = _png(np.zeros((2, 2, 2), np.uint8), 4, [0])
    with pytest.raises(ValueError, match="colour type 4"):
        ttex.decode_png(grey_alpha)


def test_missing_texture_degrades_gracefully(tmp_path):
    """A dangling ``map_Kd`` path leaves the material's constant colour."""
    (tmp_path / "broken.mtl").write_text("newmtl m\nKd 0.5 0.5 0.5\nmap_Kd not_there.png\n")
    obj = tmp_path / "broken.obj"
    obj.write_text("mtllib broken.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\n"
                   "vt 0 1\nusemtl m\nf 1/1 2/2 3/3\n")
    scene, _ = scene_from_obj(str(obj), device="cpu")
    assert int(scene.textures.num) == 0
    assert (scene.materials.tex.numpy() == -1).all()


def _golden_cfg(**kw):
    return RenderConfig(width=32, height=32, spp=16, samples_per_pass=16,
                        integrator=IntegratorConfig(max_depth=3), **kw)


def test_textured_render_golden(texbox):
    """The 32x32, 16-spp render through ``AUTO`` (the dense path) under the
    default RANDOM sampler holds the committed golden within 0.02
    mean-relative error."""
    scene, camera = texbox
    img = Renderer(scene, camera, _golden_cfg(), device="cpu").render().numpy()
    assert np.isfinite(img).all()
    ref = np.load(GOLDEN)["image"].astype(np.float32)
    rel = np.abs(img - ref).mean() / max(float(ref.mean()), 1e-6)
    assert rel < 0.02, f"mean-relative error {rel:.4f}"


def test_textured_render_agrees_with_jax(texbox, jax_texbox):
    """The port's 1-spp render of ``texbox`` against the JAX package's at
    the same (default RANDOM) sampler: at least 99% of pixels agree."""
    jscene, jcam = jax_texbox
    jcfg = mcrt_tpu.RenderConfig(width=32, height=32, spp=1, accel=JAccelType.BRUTE,
                                 integrator=JIntegratorConfig(max_depth=3))
    jimg = np.asarray(mcrt_tpu.Renderer(jscene, jcam, jcfg).render())
    timg = Renderer(*texbox, RenderConfig(width=32, height=32, spp=1,
                                          integrator=IntegratorConfig(max_depth=3)),
                    device="cpu").render().numpy()
    share = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    print(f"texbox: 1 spp per-pixel mismatch share {1.0 - share:.5f}")
    assert share >= MIN_AGREE and timg.mean() > 0.0


def test_textured_render_does_not_depend_on_the_accel(texbox):
    """The same textured render through the dense blocked path and the
    two-level path: texture fetches do not depend on the accel."""
    scene, camera = texbox
    imgs = [Renderer(scene, camera, RenderConfig(
        width=16, height=16, spp=4, samples_per_pass=4, accel=accel,
        integrator=IntegratorConfig(max_depth=2)), device="cpu").render().numpy()
        for accel in (AccelType.AUTO, AccelType.TWO_LEVEL)]
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-4, atol=1e-5)


def test_obj_import_imports_no_imaging_library():
    """``scene_from_obj`` decodes both textures with PIL blocked."""
    import subprocess
    import sys

    code = "\n".join([
        "import sys",
        "for name in ('PIL', 'jax', 'mcrt_tpu'):",
        "    sys.modules[name] = None",
        "from mcrt_tpu_torch.scene.builders import scene_from_obj",
        f"scene, _ = scene_from_obj({TEXBOX!r}, device='cpu')",
        "assert int(scene.textures.num) == 2, scene.textures.num",
        "print('ok')",
    ])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok")

