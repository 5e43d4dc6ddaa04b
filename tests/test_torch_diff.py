"""The port's inverse-rendering gradients against the JAX package's and
against finite differences.

- ``jax.grad`` and ``torch.autograd.grad`` of the summed
  ``render_spp_batch`` image, from the same scene tables and the same
  parameters (``interop.params_from_numpy``): ``cornell_box`` (16x16, 16
  spp, depth 2) for ``material_params`` and ``light_params``, the point-light
  scene of ``tests/test_diff.py`` for ``light_geometry_params``,
  ``textured_hall`` with float texels for ``texture_params``, a scene whose
  parameters sit on their clip bounds (diffuse 1.0 and 0.0, roughness 1.0
  under a glossy lobe) for ``material_params``, and ``instanced_boxes``
  (the JAX side on ``AUTO``, its two-level kernels in interpret mode) for
  ``material_params``.  The JAX side traces with its brute-force oracle
  elsewhere, the port with its plain query versions.  A pixel whose forward
  radiance differs between the packages (an intersector tie at a triangle
  edge, or ``textured_hall``'s passthrough lobe that turns on a 1-ulp
  residue, ROADMAP D2) follows another path in each, so the summed image
  is weighted by the pixels that agree (at rtol 1e-3 / atol 1e-4), which
  must be at least 99% of them.  Each field is then held to
  ``|port - jax| <= RTOL * |jax| + ATOL * max|jax|`` (``TOL``).
- The port's versions of the five gradient cases of ``tests/test_diff.py``
  against central differences of the port's own render, at that file's
  tolerances, its LBVH case replaced here by a case on ``glass_gallery``
  (31 blocks), so that the visit-list queries (K1-K3's plain versions) are
  differentiated through.  The LBVH case itself is in
  ``tests/test_torch_lbvh.py``, and ``tests/test_torch_brute.py`` holds the
  port's gradients under ``AccelType.BRUTE`` against ``jax.grad`` under the
  JAX ``BRUTE``.
- ``make_train_step``, the detached BSDF sample, the float texels and the
  queries' missing graph.  BDPT's gradients are held in
  ``tests/test_torch_bdpt_grad.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu.accel import build_intersector as j_build_intersector
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import RenderConfig as JRenderConfig
from mcrt_tpu.diff import estimators as JE
from mcrt_tpu.parallel.render import render_spp_batch as j_render_spp_batch
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.scene import scene as jscene_mod
from mcrt_tpu_torch import interop
from mcrt_tpu_torch.accel import blocked as tb
from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.accel import two_level as ttl
from mcrt_tpu_torch.bsdf import uber
from mcrt_tpu_torch.bsdf.materials import fetch_bsdf
from mcrt_tpu_torch.camera.pinhole import PinholeCamera
from mcrt_tpu_torch.config import AccelType, IntegratorConfig, RenderConfig
from mcrt_tpu_torch.core import math as m
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.diff import estimators as E
from mcrt_tpu_torch.parallel.render import make_train_step, render_spp_batch
from mcrt_tpu_torch.renderer import render_sample
from mcrt_tpu_torch.scene import builders as tbuild
from mcrt_tpu_torch.scene import scene as tscene_mod
from mcrt_tpu_torch.scene.interaction import compute_interaction
from mcrt_tpu_torch.tools import grad_check
from mcrt_tpu_torch.tools.grad_check import MIN_AGREE
from tests.test_diff import _point_light_scene as j_point_light_scene
from tests.test_torch_blocked import port_scene, random_ray_arrays
from tests.test_torch_render import _camera

torch.set_num_threads(1)

# per field: (RTOL, ATOL as a share of the field's largest JAX gradient); the
# card tests hold card gradients to CPU gradients with the same numbers
TOL = grad_check.GRAD_TOL


def _tie_scene():
    """A floor and a box under a point light, whose material parameters sit
    on the clip bounds of ``material_params``: diffuse 1.0 and 0.0 in one
    material, and roughness 1.0 (the default) under glossy lobes."""
    sb = jb.SceneBuffers()
    pos, idx = jb.quad([-2, 0, 2], [2, 0, 2], [2, 0, -2], [-2, 0, -2])
    sb.add_mesh(pos, idx, 0)
    pos, idx = jb.box([-0.4, 0.0, -0.4], [0.1, 0.6, 0.1])
    sb.add_mesh(pos, idx, 1)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    materials = [
        jscene_mod.UberMaterial(diffuse=(1.0, 0.5, 0.0), glossy=(0.2, 0.2, 0.2)),
        jscene_mod.UberMaterial(diffuse=(0.2, 0.4, 0.6), glossy=(0.5, 0.4, 0.3),
                                roughness=0.3),
    ]
    lights = jscene_mod.make_lights(
        [{"type": jscene_mod.LIGHT_POINT, "position": (0.3, 1.5, 0.2),
          "intensity": (6.0, 5.0, 4.0)}], positions, indices, face_shape)
    scene = jscene_mod.build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                                   materials, lights=lights, shape_light=shape_light)
    camera = jb.PinholeCamera.look_at(eye=(0.0, 2.0, 3.0), target=(0.0, 0.3, 0.0))
    return scene, camera


def grads_both(jscene, jcam, view, size, spp, depth, accel=JAccelType.BRUTE,
               port_accel=AccelType.AUTO):
    """(share of agreeing pixels, {field: (port grad, JAX grad)}) of the
    image sum over the agreeing pixels, both packages on the same tables;
    the JAX side under ``accel``, the port under ``port_accel``."""
    jview, tview = getattr(JE, view)(), getattr(E, view)()
    tscene, tcam = port_scene(jscene), _camera(jcam)
    jcfg = JRenderConfig(width=size, height=size, spp=spp, accel=accel,
                         integrator=JIntegratorConfig(max_depth=depth))
    cfg = RenderConfig(width=size, height=size, spp=spp, accel=port_accel,
                       integrator=IntegratorConfig(max_depth=depth))
    jisect, tisect = j_build_intersector(jscene, jcfg), build_intersector(tscene, cfg)
    frames = np.arange(spp, dtype=np.int32)
    jparams = jview.get(jscene)

    def jimage(p):
        return j_render_spp_batch(jview.set(jscene, p), jcam, jnp.asarray(frames), jcfg,
                                  jisect)

    # one compile: the image comes out as the gradient's auxiliary output
    jgrad = jax.jit(jax.grad(lambda p, w: (jnp.sum((img := jimage(p)) * w), img),
                             has_aux=True))
    n = size * size
    jg, jimg = jgrad(jparams, jnp.ones((n, 1), jnp.float32))
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                   device="cpu")
    timg = render_spp_batch(tview.set(tscene, tp), tcam, frames, cfg, tisect)
    agree = np.isclose(timg.detach().numpy(), np.asarray(jimg), rtol=1e-3, atol=1e-4).all(-1)
    w = agree.astype(np.float32)[:, None]
    if not agree.all():
        jg, _ = jgrad(jparams, jnp.asarray(w))
    tg = torch.autograd.grad((timg * torch.from_numpy(w)).sum(), list(tp.values()),
                             allow_unused=True)
    out = {k: (np.zeros(v.shape, np.float32) if g is None else g.numpy(), np.asarray(jg[k]))
           for (k, v), g in zip(tp.items(), tg)}
    return float(agree.mean()), out


CASES = {
    "cornell-material": (jb.cornell_box, "material_params", 16, 16, 2, JAccelType.BRUTE),
    "cornell-light": (jb.cornell_box, "light_params", 16, 16, 2, JAccelType.BRUTE),
    "point-light-geometry": (j_point_light_scene, "light_geometry_params", 16, 8, 2,
                             JAccelType.BRUTE),
    "hall-texels": (lambda: _float_hall(), "texture_params", 12, 4, 2, JAccelType.BRUTE),
    "ties-material": (_tie_scene, "material_params", 16, 8, 2, JAccelType.BRUTE),
    "instanced-material": (jb.instanced_boxes, "material_params", 16, 4, 2, JAccelType.AUTO),
}


def _float_hall():
    jscene, jcam = jb.textured_hall()
    return JE.with_float_texels(jscene), jcam


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_jax(case):
    builder, view, size, spp, depth, accel = CASES[case]
    jscene, jcam = builder()
    share, grads = grads_both(jscene, jcam, view, size, spp, depth, accel)
    assert share >= MIN_AGREE, share
    nonzero = 0
    for k, (t, j) in grads.items():
        rtol, atol = TOL[k]
        scale = float(np.abs(j).max())
        err = np.abs(t - j)
        print(f"{case} {k}: max |port - jax| {err.max():.3g}, max |jax| {scale:.4g}, "
              f"agreeing pixels {share:.4f}")
        assert np.isfinite(t).all(), k
        assert (err <= rtol * np.abs(j) + atol * scale).all(), (k, err.max(), scale)
        nonzero += int((np.abs(t) > 0).sum())
    assert nonzero > 0
    if case == "ties-material":  # the bounds are reached: the tie rule mattered
        assert abs(grads["roughness"][1][0]) > 0 and abs(grads["diffuse"][1][0, 2]) > 0


# --------------------------------------------------------------------------
# The port against finite differences (tests/test_diff.py's cases)
# --------------------------------------------------------------------------


def _setup(spp=16, size=16, depth=2):
    scene, camera = tbuild.cornell_box(device="cpu")
    cfg = RenderConfig(width=size, height=size, spp=spp,
                       integrator=IntegratorConfig(max_depth=depth))
    return scene, camera, cfg, build_intersector(scene, cfg), range(spp)


def _image_sum_fn(scene, camera, cfg, intersector, frames, view):
    """The image sum as a function of the parameters, on fixed sample
    streams: finite differences are exact up to float rounding."""

    def f(params):
        return render_spp_batch(view.set(scene, params), camera, frames, cfg,
                                intersector).sum()

    return f


def _grad(f, params):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    g = torch.autograd.grad(f(leaves), list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if gk is None else gk
            for (k, v), gk in zip(leaves.items(), g)}


def _eval(f, params, name, flat_values, shape):
    with torch.no_grad():
        return float(f({**params, name: torch.tensor(flat_values.reshape(shape),
                                                     dtype=torch.float32)}))


@pytest.mark.parametrize("pname,eps", [("diffuse", 1e-3), ("roughness", 1e-3)])
def test_material_grad_matches_fd(pname, eps):
    scene, camera, cfg, isect, frames = _setup()
    view = E.material_params()
    f = _image_sum_fn(scene, camera, cfg, isect, frames, view)
    params = view.get(scene)
    g = _grad(f, params)
    arr = params[pname].numpy()
    flat = arr.reshape(-1)
    picks = np.random.default_rng(0).choice(len(flat), size=min(4, len(flat)), replace=False)
    for k in picks:
        plus = np.array(flat, np.float64); plus[k] += eps
        minus = np.array(flat, np.float64); minus[k] -= eps
        fd = (_eval(f, params, pname, plus, arr.shape)
              - _eval(f, params, pname, minus, arr.shape)) / (2 * eps)
        ad = float(g[pname].reshape(-1)[k])
        assert abs(fd - ad) <= 0.05 * max(abs(fd), abs(ad), 1.0), (pname, k, fd, ad)


def test_light_intensity_grad_matches_fd():
    scene, camera, cfg, isect, frames = _setup()
    view = E.light_params()
    f = _image_sum_fn(scene, camera, cfg, isect, frames, view)
    params = view.get(scene)
    g = _grad(f, params)
    eps = 1e-2
    arr = params["intensity"].numpy()
    for k in range(3):
        plus = np.array(arr, np.float64); plus.reshape(-1)[k] += eps
        minus = np.array(arr, np.float64); minus.reshape(-1)[k] -= eps
        fd = (_eval(f, params, "intensity", plus, arr.shape)
              - _eval(f, params, "intensity", minus, arr.shape)) / (2 * eps)
        ad = float(g["intensity"].reshape(-1)[k])
        assert abs(fd - ad) <= 0.02 * max(abs(fd), 1.0), (k, fd, ad)


def test_grads_finite_and_nonzero_through_the_visit_list_path():
    """Gradients flow through the blocked visit-list queries: glass_gallery
    has 31 blocks, more than the dense path's 8."""
    scene, camera = tbuild.glass_gallery(device="cpu")
    cfg = RenderConfig(width=12, height=12, spp=4, integrator=IntegratorConfig(max_depth=2))
    isect = build_intersector(scene, cfg)
    assert isect.accel.num_blocks > tb.DENSE_BLOCKS
    view = E.material_params()
    g = _grad(_image_sum_fn(scene, camera, cfg, isect, range(4), view), view.get(scene))
    for k, v in g.items():
        assert bool(torch.isfinite(v).all()), k
    assert float(g["diffuse"].abs().sum()) > 0 and float(g["roughness"].abs().sum()) > 0


def point_light_scene(light_pos=(0.3, 1.5, 0.2), device="cpu"):
    """``tests/test_diff.py``'s open floor and box under one point light,
    built with the port's builders."""
    sb = tbuild.SceneBuffers()
    pos, idx = tbuild.quad([-2, 0, 2], [2, 0, 2], [2, 0, -2], [-2, 0, -2])
    sb.add_mesh(pos, idx, 0)
    pos, idx = tbuild.box([-0.4, 0.0, -0.4], [0.1, 0.6, 0.1])
    sb.add_mesh(pos, idx, 1)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    materials = [tscene_mod.UberMaterial(diffuse=(0.7, 0.7, 0.7)),
                 tscene_mod.UberMaterial(diffuse=(0.2, 0.4, 0.6))]
    lights = tscene_mod.make_lights(
        [{"type": tscene_mod.LIGHT_POINT, "position": light_pos,
          "intensity": (6.0, 5.0, 4.0)}], positions, indices, face_shape, device=device)
    scene = tscene_mod.build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                                   materials, lights=lights, shape_light=shape_light,
                                   device=device)
    camera = PinholeCamera.look_at(eye=(0.0, 2.0, 3.0), target=(0.0, 0.3, 0.0),
                                   fov_deg=45.0, aspect=1.0, device=device)
    return scene, camera


def test_light_position_grad_matches_fd():
    scene, camera = point_light_scene()
    cfg = RenderConfig(width=16, height=16, spp=8, integrator=IntegratorConfig(max_depth=2))
    view = E.light_geometry_params()
    f = _image_sum_fn(scene, camera, cfg, build_intersector(scene, cfg), range(8), view)
    params = view.get(scene)
    g = _grad(f, params)
    eps = 1e-3
    base = params["position"].numpy().astype(np.float64)
    for k in range(3):
        plus = base.copy(); plus.reshape(-1)[k] += eps
        minus = base.copy(); minus.reshape(-1)[k] -= eps
        fd = (_eval(f, params, "position", plus, base.shape)
              - _eval(f, params, "position", minus, base.shape)) / (2 * eps)
        ad = float(g["position"].reshape(-1)[k])
        assert abs(fd - ad) <= 0.05 * max(abs(fd), abs(ad), 1.0), (k, fd, ad)
    assert float(g["position"].abs().sum()) > 0


def test_texture_texel_grads_match_fd():
    scene, camera = tbuild.textured_hall(device="cpu")
    scene = E.with_float_texels(scene)
    cfg = RenderConfig(width=12, height=12, spp=4, integrator=IntegratorConfig(max_depth=2))
    view = E.texture_params()
    f = _image_sum_fn(scene, camera, cfg, build_intersector(scene, cfg), range(4), view)
    params = view.get(scene)
    gt = _grad(f, params)["texels"].numpy()
    assert np.isfinite(gt).all()
    nz = np.nonzero(np.abs(gt.reshape(-1)) > 1e-4)[0]
    assert len(nz) > 0
    base = params["texels"].numpy().astype(np.float64)
    eps = 1e-2
    for k in np.random.default_rng(3).choice(nz, size=min(3, len(nz)), replace=False):
        plus = base.copy(); plus.reshape(-1)[k] += eps
        minus = base.copy(); minus.reshape(-1)[k] -= eps
        fd = (_eval(f, params, "texels", plus, base.shape)
              - _eval(f, params, "texels", minus, base.shape)) / (2 * eps)
        ad = float(gt.reshape(-1)[k])
        assert abs(fd - ad) <= 0.05 * max(abs(fd), abs(ad), 1.0), (k, fd, ad)


# --------------------------------------------------------------------------
# The step, the estimator's pieces, and what carries no gradient
# --------------------------------------------------------------------------


def test_make_train_step_equals_loss_fn_and_autograd():
    scene, camera, cfg, isect, _ = _setup(spp=2, size=12)
    view = E.full_params()
    with torch.no_grad():
        target = render_spp_batch(scene, camera, [7, 8], cfg, isect) * 0.8
    step = make_train_step(camera, cfg, isect, None, view.get, view.set)
    loss, grads = step(scene, [0, 1], target)
    assert set(grads) == set(view.get(scene))
    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}
    ref = E.render_loss_fn(camera, cfg, isect, view)(params, scene, [0, 1], target)
    ref_g = torch.autograd.grad(ref, list(params.values()), allow_unused=True)
    assert torch.equal(loss, ref.detach())
    for (k, v), g in zip(params.items(), ref_g):
        assert torch.equal(grads[k], torch.zeros_like(v) if g is None else g), k
        assert grads[k].shape == v.shape
    assert float(grads["diffuse"].abs().sum()) > 0
    with pytest.raises(TypeError, match="DeviceMesh"):  # a mesh is a DeviceMesh
        make_train_step(camera, cfg, isect, object(), view.get, view.set)


@pytest.mark.parametrize("detach", [True, False])
def test_uber_sample_detaches_direction_and_pdf(detach):
    scene, _ = tbuild.glass_gallery(device="cpu")  # every lobe but pass-through
    mats = scene.materials
    diffuse = mats.diffuse.clone().requires_grad_()
    roughness = mats.roughness.clone().requires_grad_()
    scene = scene.replace(materials=mats.replace(diffuse=diffuse, roughness=roughness))
    o, d, _, _, _ = random_ray_arrays(scene, 4096, 5)  # reads the positions
    rays = Rays.make(torch.from_numpy(o), torch.from_numpy(d))
    isect = build_intersector(scene, RenderConfig(width=8, height=8))
    hit = isect.intersect(scene, rays)
    it = compute_interaction(scene, rays, hit)
    bsdf, it = fetch_bsdf(scene, it)
    wo = m.to_local(it.dpdu, it.dpdv, it.ns, it.wo)
    u3 = torch.from_numpy(np.random.default_rng(4).random((4096, 3), dtype=np.float32))
    bs = uber.sample(bsdf, wo, u3, detach=detach)
    assert bs.f.requires_grad
    assert bs.wi.requires_grad != detach
    glossy = bs.valid & ~bs.is_specular
    assert int(glossy.sum()) > 100
    assert bs.pdf.requires_grad != detach
    plain = uber.sample(bsdf, wo, u3, detach=not detach)
    for a, b in ((bs.wi, plain.wi), (bs.f, plain.f), (bs.pdf, plain.pdf)):
        assert torch.equal(a.detach(), b.detach())  # the switch moves no value


def test_float_texels_render_equal_to_the_u8_path():
    scene, camera = tbuild.textured_hall(device="cpu")
    cfg = RenderConfig(width=16, height=16, integrator=IntegratorConfig(max_depth=3))
    isect = build_intersector(scene, cfg)
    floated = E.with_float_texels(scene)
    assert scene.textures.data_f is None and floated.textures.data_f.dtype == torch.float32
    assert E.with_float_texels(floated) is floated
    with torch.no_grad():
        a = render_sample(scene, camera, 3, cfg, isect)[0]
        b = render_sample(floated, camera, 3, cfg, isect)[0]
    assert torch.equal(a, b)


def _query_inputs(builder):
    scene, _ = builder(device="cpu")
    o = torch.randn(600, 3) * 0.2
    d = m.normalize(torch.randn(600, 3))
    o.requires_grad_()
    d.requires_grad_()
    return scene, Rays.make(o + scene.center, d)


@pytest.mark.parametrize("builder", [tbuild.cornell_box, tbuild.glass_gallery,
                                     tbuild.instanced_boxes])
def test_queries_build_no_graph(builder):
    """Dense (cornell_box), visit-list (glass_gallery) and two-level
    (instanced_boxes) queries: with rays that require grad, t and the
    any-hit flags have no graph; the barycentrics keep theirs."""
    scene, rays = _query_inputs(builder)
    isect = build_intersector(scene, RenderConfig(width=8, height=8))
    acc = isect.accel
    packed, _ = tb._sorted_table(rays, acc, True)
    assert packed.requires_grad
    if isinstance(acc, ttl.TwoLevelAccel):
        outs = ttl._query2_closest(packed, acc) + (ttl._query2_any(packed, acc),)
    else:
        outs = tuple(tb._query_closest(packed, acc)) + (tb._query_any(packed, acc),)
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)
    hit = isect.intersect(scene, rays)
    assert hit.t.grad_fn is None and int(hit.valid.sum()) > 100
    assert hit.u.requires_grad
    assert isect.occluded(scene, rays).grad_fn is None
