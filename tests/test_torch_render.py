"""The slice as a whole: the port's ``Renderer`` against the JAX package's.

Both render the same scene (crossed over through ``interop``) at 32x32,
max_depth 3, under the Sobol sampler and, on ``cornell_box``, under the
default RANDOM sampler.  The JAX package uses ``AccelType.BRUTE`` (its CPU
``AUTO`` choice at these sizes); the port runs its blocked intersector with
the kernels' plain versions.  Sobol and RANDOM streams, the jitter and the
pixel order are bit-equal, so every path makes the same decisions unless a float32
last-bit difference flips one.  Tolerances:

- after 1 spp, at least 99% of pixels agree to rtol 1e-3 / atol 1e-4 (a
  flipped decision changes a whole pixel, so this is a share, not a bound);
- after 16 spp, the mean radiance agrees within 1%.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import mcrt_tpu
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.scene import builders as jb
from mcrt_tpu_torch import Renderer, interop
from mcrt_tpu_torch.camera.pinhole import PinholeCamera, pixel_uv
from mcrt_tpu_torch.config import (AccelType, BuilderType, BVHConfig, DenoiseConfig,
                                   IntegratorConfig, IntegratorType, RenderConfig,
                                   SamplerConfig, SamplerType, ToneMapConfig)
from mcrt_tpu_torch.renderer import frame_jitter
from mcrt_tpu_torch.scene import builders as tbuild
from tests.test_torch_blocked import port_scene

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, DEPTH, SPP = 32, 3, 16
MIN_AGREE = 0.99


def _camera(jcam):
    leaves, _ = jax.tree_util.tree_flatten_with_path(jcam)
    return interop.camera_from_numpy(
        {jax.tree_util.keystr(p).lstrip("."): np.asarray(v) for p, v in leaves}, device="cpu")


def _render_both(name, size=SIZE, spp=SPP, sampler="SOBOL", **integrator):
    """(port images, jax images) after 1 spp and after ``spp``, under the
    sampler type named ``sampler``."""
    jscene, jcam = getattr(jb, name)()
    jcfg = mcrt_tpu.RenderConfig(
        width=size, height=size, spp=1, accel=JAccelType.BRUTE,
        sampler=JSamplerConfig(type=JSamplerType[sampler]),
        integrator=JIntegratorConfig(max_depth=DEPTH, **integrator))
    tcfg = RenderConfig(width=size, height=size, spp=1,
                        sampler=SamplerConfig(type=SamplerType[sampler]),
                        integrator=IntegratorConfig(max_depth=DEPTH, **integrator))
    jr = mcrt_tpu.Renderer(jscene, jcam, jcfg)
    tr = Renderer(port_scene(jscene), _camera(jcam), tcfg, device="cpu")
    out = []
    for r, as_np in ((tr, lambda a: a.numpy()), (jr, np.asarray)):
        first = as_np(r.render())
        r.step(spp - 1)
        out.append((first, as_np(r.display_image())))
    return out


def _agreement(a, b):
    return np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1).mean()


@pytest.fixture(scope="module", params=["cornell_box", "glass_gallery"])
def renders(request):
    return request.param, _render_both(request.param)


def test_one_spp_agrees_per_pixel(renders):
    name, ((t1, _), (j1, _)) = renders
    assert t1.shape == j1.shape == (SIZE, SIZE, 3)
    share = _agreement(t1, j1)
    print(f"{name}: 1 spp per-pixel mismatch share {1.0 - share:.5f}")
    assert share >= MIN_AGREE
    assert np.isfinite(t1).all() and t1.mean() > 0.0


def test_sixteen_spp_mean_radiance_within_one_percent(renders):
    name, ((_, t16), (_, j16)) = renders
    print(f"{name}: {SPP} spp mean {t16.mean():.6f} (jax {j16.mean():.6f}), "
          f"per-pixel mismatch share {1.0 - _agreement(t16, j16):.5f}")
    assert abs(t16.mean() - j16.mean()) <= 0.01 * j16.mean()


def test_random_sampler_agrees_per_pixel():
    """The default sampler, RANDOM, is bit-equal too: a 1-spp
    ``cornell_box`` agrees per pixel, and so does the second sample."""
    assert SamplerConfig().type == SamplerType.RANDOM
    ((t1, t2), (j1, j2)), = [_render_both("cornell_box", spp=2, sampler="RANDOM")]
    share = _agreement(t1, j1)
    print(f"cornell_box RANDOM: 1 spp per-pixel mismatch share {1.0 - share:.5f}, "
          f"2 spp {1.0 - _agreement(t2, j2):.5f}")
    assert share >= MIN_AGREE and _agreement(t2, j2) >= MIN_AGREE
    assert np.isfinite(t1).all() and t1.mean() > 0.0


def test_mis_and_russian_roulette_agree():
    ((t1, t16), (j1, j16)), = [_render_both("cornell_box", size=16, spp=4, use_mis=True,
                                            rr_start_depth=1)]
    assert _agreement(t1, j1) >= MIN_AGREE
    assert abs(t16.mean() - j16.mean()) <= 0.01 * j16.mean()


@pytest.mark.parametrize("name", ["cornell_box", "glass_gallery"])
def test_port_builders_match_interop_scene(name):
    """The port's own builders give the scene and camera the JAX package
    builds (so ``chip_smoke.py``, which has no JAX, renders the same)."""
    jscene, jcam = getattr(jb, name)()
    crossed, cam = port_scene(jscene), _camera(jcam)
    own, own_cam = getattr(tbuild, name)(device="cpu")
    for group in ("geometry", "materials", "lights"):
        for field, v in vars(getattr(crossed, group)).items():
            if isinstance(v, torch.Tensor):
                torch.testing.assert_close(getattr(getattr(own, group), field), v,
                                           rtol=0, atol=0, msg=f"{group}.{field}")
    for field, v in vars(cam).items():
        torch.testing.assert_close(getattr(own_cam, field), v, rtol=1e-6, atol=1e-6)


def _jax_sphere_field(subdiv):
    """``sphere_field`` written with the JAX package's builders."""
    sb = jb.SceneBuffers()
    fp, fi = jb.quad([-5.0, 0, 5.0], [5.0, 0, 5.0], [5.0, 0, -5.0], [-5.0, 0, -5.0])
    sb.add_mesh(fp, fi, 0)
    unit_p, unit_i, unit_n = jb.icosphere((0.0, 0.0, 0.0), 0.6, subdiv=subdiv)
    for k in range(12):
        center = np.asarray([(k % 4 - 1.5) * 1.6, 0.6, (k // 4 - 1.0) * 1.6], np.float32)
        sb.add_mesh(unit_p + center, unit_i, 1 + k % 3, normals=unit_n)
    lp, li = jb.quad([-1.5, 4.0, -1.5], [1.5, 4.0, -1.5], [1.5, 4.0, 1.5], [-1.5, 4.0, 1.5])
    light_shape = sb.add_mesh(lp, li, 4, light_id=0)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    lights = jb.make_lights([{"type": jb.LIGHT_MESH, "intensity": (14.0, 13.0, 12.0),
                              "shape": light_shape}], positions, indices, face_shape)
    mats = [jb.UberMaterial(**vars(mat)) for mat in tbuild.GALLERY_MATERIALS]
    return jb.build_scene(positions, normals, uvs, indices, face_shape, shape_mat, mats,
                          lights=lights, shape_light=shape_light)


def test_sphere_field_matches_jax_builders_and_renders():
    """The main-path stand-in scene at subdiv 1 (964 triangles; 245,764 at
    the default subdiv 5) equals the same scene built with the JAX package's
    builders, and the port renders it as the JAX package does (16x16, 1 spp,
    at least 99% of pixels within rtol 1e-3 / atol 1e-4)."""
    jscene = _jax_sphere_field(1)
    own, cam = tbuild.sphere_field(subdiv=1, device="cpu")
    assert int(own.geometry.face_valid.sum()) == 12 * 20 * 4 + 4
    crossed = port_scene(jscene)
    for group in ("geometry", "materials", "lights"):
        for field, v in vars(getattr(crossed, group)).items():
            if isinstance(v, torch.Tensor):
                torch.testing.assert_close(getattr(getattr(own, group), field), v,
                                           rtol=0, atol=0, msg=f"{group}.{field}")
    jcam = jb.PinholeCamera.look_at(eye=(0.0, 3.2, 7.5), target=(0.0, 0.5, 0.0),
                                    fov_deg=45.0, aspect=1.0)
    jimg = np.asarray(mcrt_tpu.Renderer(jscene, jcam, mcrt_tpu.RenderConfig(
        width=16, height=16, spp=1, accel=JAccelType.BRUTE,
        sampler=JSamplerConfig(type=JSamplerType.SOBOL),
        integrator=JIntegratorConfig(max_depth=DEPTH))).render())
    timg = Renderer(own, cam, RenderConfig(
        width=16, height=16, spp=1, sampler=SamplerConfig(type=SamplerType.SOBOL),
        integrator=IntegratorConfig(max_depth=DEPTH)), device="cpu").render().numpy()
    assert _agreement(timg, jimg) >= MIN_AGREE and timg.mean() > 0.0


def test_port_imports_and_renders_without_jax():
    """``import mcrt_tpu_torch`` (every module) succeeds with jax, flax and
    the JAX package blocked, and a tiny render runs."""
    code = "\n".join([
        "import sys, pkgutil, importlib",
        "for name in ('jax', 'jaxlib', 'flax', 'mcrt_tpu'):",
        "    sys.modules[name] = None",
        "import mcrt_tpu_torch",
        "for m in pkgutil.walk_packages(mcrt_tpu_torch.__path__, 'mcrt_tpu_torch.'):",
        "    importlib.import_module(m.name)",
        "from mcrt_tpu_torch import Renderer, RenderConfig",
        "from mcrt_tpu_torch.scene.builders import cornell_box",
        "img = Renderer(*cornell_box(device='cpu'), RenderConfig(width=8, height=8, spp=1),",
        "               device='cpu').render()",
        "assert img.shape == (8, 8, 3) and bool(img.isfinite().all()), img",
        "print('ok', float(img.mean()))",
    ])
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok")


def test_progressive_controls():
    """``stop_at_spp`` pauses the render, ``update_camera`` resets it."""
    scene, cam = tbuild.cornell_box(device="cpu")
    r = Renderer(scene, cam, RenderConfig(width=8, height=8, stop_at_spp=3), device="cpu")
    r.step(5)
    assert r.accum.frame == 3 and r.stopped()
    moved = cam.replace(position=cam.position + 0.1)
    r.update_camera(moved)
    assert r.accum.frame == 0 and float(r.accum.weight.sum()) == 0.0
    assert torch.equal(r.camera.position, moved.position)
    img = r.render(2)
    assert r.accum.frame == 2 and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("change, match", [
    (dict(accel=AccelType.BRUTE), "not ported"),
    (dict(accel=AccelType.LBVH), "not ported"),
])
def test_unported_options_raise(change, match):
    scene, cam = tbuild.cornell_box(device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        Renderer(scene, cam, RenderConfig(width=8, height=8, **change),
                 device="cpu").render(1)


@pytest.mark.parametrize("option", ["tonemap", "denoise"])
def test_display_image_applies_tonemap_and_denoise(option):
    """``display_image`` runs the enabled pass over the accumulated image
    (``tests/test_torch_cli.py`` holds both passes against the JAX
    package's); the accumulation itself is the plain render's."""
    from mcrt_tpu_torch.film import denoise, tonemap

    scene, cam = tbuild.cornell_box(device="cpu")
    plain = Renderer(scene, cam, RenderConfig(width=8, height=8), device="cpu")
    change = {"tonemap": ToneMapConfig(enabled=True),
              "denoise": DenoiseConfig(enabled=True, radius=1)}[option]
    cfg = RenderConfig(width=8, height=8, **{option: change})
    r = Renderer(scene, cam, cfg, device="cpu")
    img = r.render(2)
    assert torch.equal(r.accum.image, plain.render(2))
    want = (tonemap.reinhard(r.accum.image, change) if option == "tonemap"
            else denoise.bilateral(r.accum.image, change))
    assert torch.equal(img, want) and not torch.equal(img, r.accum.image)


def test_bdpt_renderer_and_spp_batch():
    """A BDPT ``Renderer`` on ``cornell_box`` renders a finite image with a
    positive mean, and ``render_spp_batch`` under BDPT equals the mean of
    its samples rendered one by one."""
    from mcrt_tpu_torch.parallel.render import render_spp_batch
    from mcrt_tpu_torch.renderer import render_sample

    scene, cam = tbuild.cornell_box(device="cpu")
    cfg = RenderConfig(width=12, height=8, spp=2,
                       integrator=IntegratorConfig(type=IntegratorType.BDPT, max_depth=3))
    r = Renderer(scene, cam, cfg, device="cpu")
    img = r.render()
    assert img.shape == (8, 12, 3) and bool(torch.isfinite(img).all()) and img.mean() > 0.0
    frames = [0, 1, 2]
    with torch.no_grad():
        batch = render_spp_batch(r.scene, r.camera, frames, cfg, r.intersector)
        each = torch.stack([render_sample(r.scene, r.camera, f, cfg, r.intersector)[0]
                            for f in frames]).mean(0)
    assert batch.shape == (12 * 8, 3) and batch.mean() > 0.0
    assert torch.equal(batch, each)


def test_render_spp_batch_refuses_a_mesh(tmp_path):
    """In a one-rank gloo group, ``render_spp_batch`` over a (1, 1)
    ``DeviceMesh`` equals the unsharded call, and a mesh that is not a
    ``DeviceMesh`` raises ``TypeError``."""
    import torch.distributed as dist

    from mcrt_tpu_torch.accel import build_intersector
    from mcrt_tpu_torch.parallel.mesh import init_process_group, make_mesh
    from mcrt_tpu_torch.parallel.render import render_spp_batch

    scene, cam = tbuild.cornell_box(device="cpu")
    cfg = RenderConfig(width=8, height=8)
    isect = build_intersector(scene, cfg)
    init_process_group("cpu", f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        with torch.no_grad():
            sharded = render_spp_batch(scene, cam, [0, 1], cfg, isect,
                                       mesh=make_mesh(device="cpu"))
            assert torch.equal(sharded, render_spp_batch(scene, cam, [0, 1], cfg, isect))
        with pytest.raises(TypeError, match="DeviceMesh"):
            render_spp_batch(scene, cam, [0, 1], cfg, isect, mesh=object())
    finally:
        dist.destroy_process_group()


def test_sbvh_render_agrees_with_sah_render():
    """``BuilderType.SBVH`` (the spatial-split blocks) renders
    ``cornell_box`` as SAH blocks do: at least 99% of pixels agree after
    one sample, and the accel says which builder ran."""
    scene, cam = tbuild.cornell_box(device="cpu")
    imgs = {}
    for builder in (BuilderType.SAH, BuilderType.SBVH):
        r = Renderer(scene, cam, RenderConfig(width=SIZE, height=SIZE, spp=1,
                                              bvh=BVHConfig(builder=builder),
                                              integrator=IntegratorConfig(max_depth=DEPTH)),
                     device="cpu")
        assert r.intersector.accel.builder == builder.value
        imgs[builder] = r.render().numpy()
    assert _agreement(imgs[BuilderType.SBVH], imgs[BuilderType.SAH]) >= MIN_AGREE
    assert imgs[BuilderType.SBVH].mean() > 0.0


def test_entry_points_default_to_the_card():
    """With no ``device``, the entry points target CUDA: where there is no
    card they raise, naming ``device="cpu"``, and never run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would run on it")
    scene, cam = tbuild.cornell_box(device="cpu")
    cfg = RenderConfig(width=8, height=8, spp=1)
    calls = [lambda: Renderer(scene, cam, cfg), tbuild.cornell_box,
             tbuild.textured_hall, lambda: tbuild.instanced_boxes(2),
             lambda: PinholeCamera.look_at((0, 0, 1), (0, 0, 0)),
             lambda: pixel_uv(4, 4), lambda: frame_jitter(0)]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
