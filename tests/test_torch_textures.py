"""The port's texture stack (``mcrt_tpu_torch/scene/textures.py``, the
texture and normal-map branches of ``bsdf/materials.py``, the
``textured_hall`` builder) against the JAX package.

Atlas tables are integers and bytes: equal.  Texture samples agree to
atol 1e-6 (float32 bilinear and trilinear weights); the shading frame and
BSDF parameters of ``fetch_bsdf`` to the rtol 1e-5 / atol 1e-6 of
``test_torch_shading.py``; a 1-spp 32x32 Sobol render of ``textured_hall``
agrees with the JAX package's on at least 99% of pixels at rtol 1e-3 /
atol 1e-4 (a flipped decision changes a whole pixel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcrt_tpu
from mcrt_tpu.accel.brute import intersect_brute
from mcrt_tpu.bsdf import materials as jmat
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.core.types import Rays as JRays
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.scene import interaction as jint
from mcrt_tpu.scene import textures as jtex
from mcrt_tpu_torch import Renderer
from mcrt_tpu_torch.bsdf import materials as tmat
from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig, SamplerConfig, SamplerType
from mcrt_tpu_torch.core.types import Hit, RayDiff, Rays
from mcrt_tpu_torch.scene import builders as tbuild
from mcrt_tpu_torch.scene import interaction as tint
from mcrt_tpu_torch.scene import textures as ttex
from tests.test_torch_blocked import port_scene
from tests.test_torch_render import _camera

# one torch thread per test process (see test_torch_blocked.py)
torch.set_num_threads(1)

ATLAS_FIELDS = ("data", "offset", "width", "height", "mips", "wrap")
N = 4096


def _images():
    """Textures of odd, non-square and square sizes, float RGB and uint8
    RGBA, from a numpy seed."""
    rng = np.random.default_rng(7)
    return [(rng.random((37, 21, 3)).astype(np.float32), ttex.WRAP_REPEAT),
            (rng.integers(0, 256, (16, 16, 4), dtype=np.uint8), ttex.WRAP_CLAMP),
            (rng.random((5, 64, 3)).astype(np.float32), ttex.WRAP_MIRROR),
            (rng.integers(0, 256, (9, 9, 4), dtype=np.uint8), ttex.WRAP_BORDER)]


def _atlases(build_mips=True):
    ja, ta = jtex.AtlasBuilder(build_mips), ttex.AtlasBuilder(build_mips)
    for img, wrap in _images():
        assert ja.add(img, wrap) == ta.add(img, wrap)
    return ja.build(), ta.build()


@pytest.mark.parametrize("build_mips", [True, False])
def test_atlas_tables_equal(build_mips):
    ja, ta = _atlases(build_mips)
    assert ta.num == ja.num == 4
    for k in ATLAS_FIELDS:
        a, b = getattr(ta, k).numpy(), np.asarray(getattr(ja, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert ttex.AtlasBuilder().build().num == jtex.AtlasBuilder().build().num == 0


def _lookups(seed):
    """Texture ids (some -1), uvs outside [0, 1] and uv footprints spanning
    every mip level."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(-1, 4, N).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    duv = (rng.normal(size=(2, N, 2)) * 10.0 ** rng.uniform(-4, 1, (2, N, 1))).astype(np.float32)
    return tex, uv, duv[0], duv[1]


@pytest.mark.parametrize("wrap", [ttex.WRAP_REPEAT, ttex.WRAP_CLAMP, ttex.WRAP_MIRROR,
                                  ttex.WRAP_BORDER])
@pytest.mark.parametrize("differentials", [False, True])
def test_sample_texture_matches_jax(wrap, differentials):
    """Every wrap mode (the texture of that mode plus the -1 lanes), with
    and without ray differentials (trilinear and bilinear)."""
    ja, ta = _atlases()
    tex, uv, dx, dy = _lookups(seed=wrap)
    tex = np.where(tex >= 0, wrap, -1).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (tex, uv)]
    targs = [torch.from_numpy(a) for a in (tex, uv)]
    if differentials:
        jargs += [jnp.asarray(dx), jnp.asarray(dy)]
        targs += [torch.from_numpy(dx), torch.from_numpy(dy)]
    j = np.asarray(jtex.sample_texture(ja, *jargs))
    t = ttex.sample_texture(ta, *targs).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert (t[tex < 0] == 1.0).all() and 0.0 < t[tex >= 0].mean() < 1.0


def test_wrap_coord_and_lod_match_jax():
    """``_wrap_coord`` is a floor modulo on negative coordinates (exact), and
    ``compute_lod`` agrees to rtol 1e-6."""
    x = np.arange(-40, 41, dtype=np.int32)
    n = np.full_like(x, 7)
    for mode in range(4):
        np.testing.assert_array_equal(
            ttex._wrap_coord(torch.from_numpy(x), torch.from_numpy(n),
                             torch.full_like(torch.from_numpy(x), mode)).numpy(),
            np.asarray(jtex._wrap_coord(jnp.asarray(x), jnp.asarray(n), mode)))
    ja, ta = _atlases()
    tex, _, dx, dy = _lookups(seed=11)
    j = np.asarray(jtex.compute_lod(ja, jnp.asarray(tex), jnp.asarray(dx), jnp.asarray(dy)))
    t = ttex.compute_lod(ta, torch.from_numpy(tex), torch.from_numpy(dx),
                         torch.from_numpy(dy)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    assert j.max() > 3.0 and j.min() == 0.0


@pytest.fixture(scope="module")
def hall():
    """(jax scene, port scene from interop, jax camera)."""
    jscene, jcam = jb.textured_hall()
    return jscene, port_scene(jscene), jcam


def test_textured_hall_builder_matches_jax(hall):
    jscene, crossed, _ = hall
    own, cam = tbuild.textured_hall(device="cpu")
    for group in ("geometry", "shapes", "materials", "lights", "textures"):
        for name, field in vars(getattr(crossed, group)).items():
            if isinstance(field, torch.Tensor):
                np.testing.assert_array_equal(getattr(getattr(own, group), name).numpy(),
                                              field.numpy(), err_msg=f"{group}.{name}")
    assert own.materials.used_slots == crossed.materials.used_slots \
        == tuple(jscene.materials.used_slots)
    assert own.textures.num == 3 and own.materials.used_slots[0] and own.materials.used_slots[7]


def test_fetch_bsdf_with_textures_and_normal_map_matches_jax(hall):
    """Primary hits of ``textured_hall`` with ray differentials: texture
    modulation (trilinear), the diffuse alpha and the normal-mapped frame."""
    jscene, tscene, jcam = hall
    rng = np.random.default_rng(5)
    uv = rng.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    o, d = jcam.generate_rays(jnp.asarray(uv))
    jrays = JRays.make(jnp.broadcast_to(o, d.shape), d)
    jdiff = jcam.generate_ray_differentials(jnp.asarray(uv), 64, 64)
    jhit = intersect_brute(jscene.geometry, jrays)
    to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    trays = Rays(**{k: to_t(getattr(jrays, k)) for k in ("o", "d", "tmin", "tmax", "active")})
    thit = Hit(**{k: to_t(getattr(jhit, k)) for k in ("t", "prim", "shape", "u", "v", "valid")})
    tdiff = RayDiff(dddx=to_t(jdiff.dddx), dddy=to_t(jdiff.dddy))
    jb_, ji = jmat.fetch_bsdf(jscene, jint.compute_interaction(jscene, jrays, jhit, diff=jdiff))
    tb_, ti = tmat.fetch_bsdf(tscene, tint.compute_interaction(tscene, trays, thit, diff=tdiff))
    for name in ("diffuse", "glossy", "kr", "kt", "passthrough", "alpha", "eta"):
        np.testing.assert_allclose(getattr(tb_, name).numpy(), np.asarray(getattr(jb_, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("ns", "dpdu", "dpdv"):
        np.testing.assert_allclose(getattr(ti, name).numpy(), np.asarray(getattr(ji, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    floor = np.asarray(jhit.valid) & (np.asarray(ji.material) == 0)
    assert floor.sum() > 500
    # the normal map tilts the floor's shading normal away from +y
    assert np.abs(ti.ns.numpy()[floor, 0]).max() > 0.1
    assert np.ptp(tb_.diffuse.numpy()[floor, 0]) > 0.3  # the checkerboard


def test_textured_hall_render_agrees_with_jax(hall):
    jscene, tscene, jcam = hall
    jimg = np.asarray(mcrt_tpu.Renderer(jscene, jcam, mcrt_tpu.RenderConfig(
        width=32, height=32, spp=1, accel=JAccelType.BRUTE,
        sampler=JSamplerConfig(type=JSamplerType.SOBOL),
        integrator=JIntegratorConfig(max_depth=3))).render())
    timg = Renderer(tscene, _camera(jcam), RenderConfig(
        width=32, height=32, spp=1, sampler=SamplerConfig(type=SamplerType.SOBOL),
        integrator=IntegratorConfig(max_depth=3)), device="cpu").render().numpy()
    share = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    print(f"textured_hall: 1 spp per-pixel mismatch share {1.0 - share:.5f}")
    assert share >= 0.99 and np.isfinite(timg).all() and timg.mean() > 0.0
