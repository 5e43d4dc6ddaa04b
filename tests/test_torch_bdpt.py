"""The port's BDPT against the JAX package's.

Every case builds its inputs once, with numpy, and hands the same arrays
to both packages (scenes and cameras crossed over through ``interop``):

- the camera's importance functions (``world_to_uv``, ``eval_we``,
  ``pdf_we``, ``sample_wi``) on random directions and points, many outside
  the frustum, over an (S, N) leading shape: allclose at rtol 1e-5 /
  atol 1e-6, the frustum flags equal;
- the lights' emission sampling (``sample_le``, ``pdf_le``) for the four
  light types (the mesh light of ``cornell_box``, the point and directional
  lights of ``textured_hall``, a disk light built with ``make_lights``),
  light ids -1 included, on (S, N) inputs: the same tolerance;
- ``bdpt.trace`` on ``cornell_box`` at 16x16, 1 spp, depths 2 and 3, both
  samplers, and ``s1_only``: at least 99% of pixels within rtol 1e-3 /
  atol 1e-4 and the image means within 1e-4 relative.  The JAX side traces
  with its brute-force oracle, the port with its dense intersector's plain
  version, so both get the same camera rays, jittered in each pixel from
  a numpy seed: pixel-centre rays of the symmetric box run exactly through
  triangle edges, where the two intersectors break the tie differently
  (one or two pixels of 256, which moves the mean by about 1e-3);
- the port's versions of ``tests/test_bdpt.py``, at that file's sample
  counts and bounds.  The converged estimates trace their samples in
  batches: a wavefront of K copies of the film, each lane with its own
  RANDOM stream (the sample index and the lane), t=1 splats routed to the
  first copy, the copies summed; the same estimator as one sample a pass.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
from mcrt_tpu.camera.pinhole import pixel_uv as j_pixel_uv
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.core.types import Rays as JRays
from mcrt_tpu.integrators import bdpt as jbdpt
from mcrt_tpu.lights import lights as jlt
from mcrt_tpu.sampling import rng as jrng
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.scene import scene as jscene_mod
from mcrt_tpu_torch import Renderer
from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.config import (IntegratorConfig, IntegratorType, RenderConfig,
                                   SamplerConfig, SamplerType)
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.integrators import bdpt
from mcrt_tpu_torch.integrators import path as pt
from mcrt_tpu_torch.lights import lights as tlt
from mcrt_tpu_torch.sampling import rng
from tests.test_bdpt import _directional_scene
from tests.test_torch_blocked import port_scene
from tests.test_torch_render import _camera

torch.set_num_threads(1)

W = 16
N = W * W
MIN_AGREE = 0.99
BATCH = 64  # samples a wavefront in the converged estimates


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _both(builder):
    jscene, jcam = builder()
    return (jscene, jcam), (port_scene(jscene), _camera(jcam))


@pytest.fixture(scope="module")
def cornell():
    return _both(jb.cornell_box)


# --------------------------------------------------------------------------
# Camera importance functions
# --------------------------------------------------------------------------


def test_camera_importance_functions_match_jax(cornell):
    (_, jcam), (_, tcam) = cornell
    rng_np = np.random.default_rng(0)
    shape = (3, 200)
    # half the directions near the view direction (mostly inside the
    # frustum), half anywhere (mostly outside it)
    fwd = np.asarray(jcam.forward)
    d = rng_np.normal(size=shape + (3,)).astype(np.float32)
    d[:, :100] = fwd + 0.35 * d[:, :100]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = (np.asarray(jcam.position) + 2.5 * fwd
         + rng_np.uniform(-1.5, 1.5, shape + (3,))).astype(np.float32)
    p[0, :20] = np.asarray(jcam.position) - fwd * rng_np.uniform(0.5, 2.0, (20, 1))  # behind

    (juv, jin), (tuv, tin) = jcam.world_to_uv(jnp.asarray(d)), tcam.world_to_uv(
        torch.from_numpy(d))
    assert 0 < int(jin.sum()) < jin.size
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    _close(tuv, juv)
    _close(tcam.eval_we(torch.from_numpy(d)), jcam.eval_we(jnp.asarray(d)))
    for a, b in zip(tcam.pdf_we(torch.from_numpy(d)), jcam.pdf_we(jnp.asarray(d))):
        _close(a, b)
    j_out = jcam.sample_wi(jnp.asarray(p))
    t_out = tcam.sample_wi(torch.from_numpy(p))
    assert 0 < int(j_out[5].sum()) < j_out[5].size
    for a, b in zip(t_out, j_out):
        if b.dtype == jnp.bool_:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b)
    assert t_out[0].shape == shape + (3,) and t_out[2].shape == shape


# --------------------------------------------------------------------------
# Light emission sampling
# --------------------------------------------------------------------------


def _disk_scene():
    """A floor and a back wall lit by a disk light (and nothing else)."""
    sb = jb.SceneBuffers()
    pos, idx = jb.quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1])
    sb.add_mesh(pos, idx, 0)
    pos, idx = jb.quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1])
    sb.add_mesh(pos, idx, 0)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    lights = jscene_mod.make_lights(
        [{"type": jscene_mod.LIGHT_DISK, "position": (0.2, 1.6, 0.1),
          "direction": (0.1, -1.0, 0.2), "radius": 0.35, "intensity": (4.0, 3.5, 3.0)}],
        positions, indices, face_shape)
    scene = jscene_mod.build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                                   [jscene_mod.UberMaterial(diffuse=(0.7, 0.7, 0.7))],
                                   lights=lights, shape_light=shape_light)
    return scene, jb.PinholeCamera.look_at(eye=(0.0, 1.0, 3.0), target=(0.0, 0.8, 0.0))


@pytest.mark.parametrize("builder, ltype", [
    (jb.cornell_box, jscene_mod.LIGHT_MESH),
    (jb.textured_hall, jscene_mod.LIGHT_POINT),
    (jb.textured_hall, jscene_mod.LIGHT_DIRECTIONAL),
    (_disk_scene, jscene_mod.LIGHT_DISK),
], ids=["mesh", "point", "directional", "disk"])
def test_sample_le_and_pdf_le_match_jax(builder, ltype):
    (jscene, _), (tscene, _) = _both(builder)
    types = np.asarray(jscene.lights.type)
    light = int(np.nonzero(types == ltype)[0][0])
    rng_np = np.random.default_rng(1)
    shape = (2, 64)
    ids = np.full(shape, light, np.int32)
    ids[1, :8] = -1  # invalid ids read the first light, clipped, as jnp.take does
    u_pos = rng_np.random(shape + (2,), dtype=np.float32)
    u_dir = rng_np.random(shape + (2,), dtype=np.float32)
    js = jlt.sample_le(jscene, jnp.asarray(ids), jnp.asarray(u_pos), jnp.asarray(u_dir))
    ts = tlt.sample_le(tscene, torch.from_numpy(ids), torch.from_numpy(u_pos),
                       torch.from_numpy(u_dir))
    for f in dataclasses.fields(ts):
        a, b = getattr(ts, f.name), getattr(js, f.name)
        assert tuple(a.shape) == b.shape, f.name
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            _close(a, b)
    assert bool(ts.valid[0].all()) and not bool(ts.valid[1, :8].any())
    d = rng_np.normal(size=shape + (3,)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jp = jlt.pdf_le(jscene, jnp.asarray(ids), js.n, jnp.asarray(d))
    tp = tlt.pdf_le(tscene, torch.from_numpy(ids), ts.n, torch.from_numpy(d))
    for a, b in zip(tp, jp):
        _close(a, b)
    if ltype == jscene_mod.LIGHT_DIRECTIONAL:
        assert not bool(tp[1][0].any())  # a delta direction has pdf_dir 0 for MIS
    if ltype == jscene_mod.LIGHT_POINT:
        assert not bool(tp[0][0].any())  # a delta position has pdf_pos 0 for MIS


def test_sample_li_without_lights_keeps_the_ids_shape():
    """A scene without lights: ``sample_li`` on (S, N) ids returns (S, N, 3)
    and (S, N) fields, equal to the JAX package's for the same ids
    flattened (its own empty sample takes the ids' first dimension only)."""
    (jscene, _), (tscene, _) = _both(jb.cornell_box)
    jscene = jscene.replace(lights=jscene_mod.Lights.empty())
    tscene = port_scene(jscene)
    assert tscene.lights.capacity == 0
    shape = (3, 5)
    rng_np = np.random.default_rng(2)
    p = rng_np.normal(size=shape + (3,)).astype(np.float32)
    u = rng_np.random(shape + (2,), dtype=np.float32)
    ts = tlt.sample_li(tscene, torch.zeros(shape, dtype=torch.int32), torch.from_numpy(p),
                       torch.from_numpy(u))
    js = jlt.sample_li(jscene, jnp.zeros((15,), jnp.int32), jnp.asarray(p.reshape(15, 3)),
                       jnp.asarray(u.reshape(15, 2)))
    for f in dataclasses.fields(ts):
        a, b = getattr(ts, f.name), np.asarray(getattr(js, f.name))
        assert tuple(a.shape) == shape + b.shape[1:], f.name
        np.testing.assert_array_equal(a.reshape(b.shape).numpy(), b, err_msg=f.name)


# --------------------------------------------------------------------------
# bdpt.trace against the JAX package's
# --------------------------------------------------------------------------


def _jittered_rays(jcam):
    jit = np.random.default_rng(0).uniform(-0.5, 0.5, (N, 2)).astype(np.float32)
    o, d = jcam.generate_rays(j_pixel_uv(W, W, jitter=jnp.asarray(jit)))
    return np.asarray(o), np.asarray(d)


@pytest.mark.parametrize("depth, sampler, s1_only", [
    (2, "SOBOL", False), (2, "RANDOM", False), (3, "SOBOL", False), (3, "RANDOM", False),
    (2, "SOBOL", True)])
def test_trace_matches_jax(cornell, depth, sampler, s1_only):
    (jscene, jcam), (tscene, tcam) = cornell
    o, d = _jittered_rays(jcam)
    jstream = jrng.make_stream(JSamplerConfig(type=JSamplerType[sampler]), jnp.asarray(0),
                               jnp.arange(N))
    jimg = np.asarray(jax.jit(lambda s: jbdpt.trace(
        s, jcam, JRays.make(jnp.asarray(o), jnp.asarray(d)), jstream,
        JIntegratorConfig(max_depth=depth), lambda sc, r: intersect_brute(sc.geometry, r),
        lambda sc, r: occluded_brute(sc.geometry, r), s1_only=s1_only))(jscene))
    isect = build_intersector(tscene, RenderConfig(width=W, height=W))
    tstream = rng.make_stream(SamplerConfig(type=SamplerType[sampler]), 0, torch.arange(N))
    with torch.no_grad():
        timg = bdpt.trace(tscene, tcam, Rays.make(torch.from_numpy(o), torch.from_numpy(d)),
                          tstream, IntegratorConfig(max_depth=depth), isect.intersect,
                          isect.occluded, s1_only=s1_only).numpy()
    share = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    print(f"depth {depth} {sampler} s1_only={s1_only}: agreeing share {share:.4f}, means "
          f"{timg.mean():.7f} / {jimg.mean():.7f}")
    assert timg.shape == (N, 3) and np.isfinite(timg).all()
    assert share >= MIN_AGREE
    assert abs(timg.mean() - jimg.mean()) <= 1e-4 * jimg.mean()


# --------------------------------------------------------------------------
# The port's versions of tests/test_bdpt.py
# --------------------------------------------------------------------------


def _converged(scene, camera, cfg, use_bdpt, spp, s1_only=False, seed=0, jitter=True):
    """The mean of ``spp`` one-sample estimates of a W x W film (default
    RANDOM sampler), traced ``BATCH`` samples a wavefront."""
    isect = build_intersector(scene, RenderConfig(width=W, height=W))
    gen = torch.Generator().manual_seed(99 + seed)
    base = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(W), indexing="ij"),
                       -1).reshape(N, 2).flip(-1).float()  # (col, row), row-major
    acc = torch.zeros((N, 3), dtype=torch.float64)
    done = 0
    with torch.no_grad():
        while done < spp:
            k = min(BATCH, spp - done)
            off = torch.rand((k, N, 2), generator=gen) - 0.5 if jitter else torch.zeros(k, N, 2)
            uv = ((base + 0.5 + off) / W).reshape(k * N, 2)
            o, d = camera.generate_rays(uv)
            stream = rng.make_stream(SamplerConfig(), seed * 100003 + done,
                                     torch.arange(k * N))
            rays = Rays.make(o, d)
            if use_bdpt:
                r = bdpt.trace(scene, camera, rays, stream, cfg, isect.intersect,
                               isect.occluded, s1_only=s1_only, film=(W, W),
                               slot_of_pixel=torch.arange(N))
            else:
                r = pt.trace(scene, rays, stream, cfg, isect.intersect, isect.occluded)
            acc += r.reshape(k, N, 3).sum(0).double()
            done += k
    return (acc / spp).float().numpy()


def _rel_outside_emitter(a, b):
    mask = a.max(-1) < 5.0  # the directly visible emitter (s=0 aside)
    return np.abs(a - b)[mask].mean() / a[mask].mean()


def test_bdpt_finite(cornell):
    _, (scene, camera) = cornell
    from mcrt_tpu_torch.camera.pinhole import pixel_uv

    o, d = camera.generate_rays(pixel_uv(W, W, device="cpu"))
    isect = build_intersector(scene, RenderConfig(width=W, height=W))
    with torch.no_grad():
        L = bdpt.trace(scene, camera, Rays.make(o, d),
                       rng.make_stream(SamplerConfig(), 0, torch.arange(N)),
                       IntegratorConfig(max_depth=2), isect.intersect, isect.occluded)
    assert bool(torch.isfinite(L).all())
    assert float(L.mean()) > 0.01


def test_s1_only_matches_forward_pt(cornell):
    """s=1-restricted BDPT equals the NEE-only path tracer on the pixels
    that do not see the emitter (unjittered pixel-centre rays)."""
    _, (scene, camera) = cornell
    cfg = IntegratorConfig(max_depth=2)
    a = _converged(scene, camera, cfg, use_bdpt=False, spp=512, jitter=False)
    b = _converged(scene, camera, cfg, use_bdpt=True, s1_only=True, spp=512, jitter=False)
    rel = _rel_outside_emitter(a, b)
    print(f"s1_only against PT: rel {rel:.4f}")
    assert rel < 0.06, rel


def test_full_bdpt_matches_pt_converged(cornell):
    _, (scene, camera) = cornell
    cfg = IntegratorConfig(max_depth=2)
    a = _converged(scene, camera, cfg, use_bdpt=False, spp=1024)
    b = _converged(scene, camera, cfg, use_bdpt=True, spp=1024)
    rel = _rel_outside_emitter(a, b)
    print(f"BDPT against PT: rel {rel:.4f}, means {b.mean():.5f} / {a.mean():.5f}")
    assert rel < 0.04, rel
    assert abs(a.mean() - b.mean()) / a.mean() < 0.02


def test_bdpt_through_renderer(cornell):
    _, (scene, camera) = cornell
    cfg = RenderConfig(width=16, height=16, spp=8, samples_per_pass=8,
                       integrator=IntegratorConfig(type=IntegratorType.BDPT, max_depth=2))
    img = Renderer(scene, camera, cfg, device="cpu").render().numpy()
    assert np.isfinite(img).all()
    assert img.mean() > 0.05


def test_bdpt_nonsquare_film_matches_pt(cornell):
    """The t=1 splats address the true (W, H) film through the renderer's
    Morton ray order: a converged non-square BDPT render through
    ``Renderer`` agrees with the path tracer's per pixel."""
    _, (scene, camera) = cornell
    w, h, spp = 32, 16, 512
    imgs = {}
    for ityp in (IntegratorType.PATH, IntegratorType.BDPT):
        cfg = RenderConfig(width=w, height=h, spp=spp, samples_per_pass=64,
                           integrator=IntegratorConfig(type=ityp, max_depth=2))
        imgs[ityp] = Renderer(scene, camera, cfg, device="cpu").render().numpy()
    a, b = imgs[IntegratorType.PATH], imgs[IntegratorType.BDPT]
    assert a.shape == b.shape == (h, w, 3)
    rel = _rel_outside_emitter(a, b)
    print(f"non-square film: rel {rel:.4f}")
    # a square-film (or unrouted) splat would scramble whole rows: rel > 0.5
    assert rel < 0.08, rel


def test_bdpt_directional_light_subpaths():
    """A scene lit only by a directional light: the s >= 2 light subpaths
    that start on the scene-radius disk MIS-combine with s=1 into the image
    the path tracer converges to."""
    jscene, jcam = _directional_scene()
    scene, camera = port_scene(jscene), _camera(jcam)
    cfg = IntegratorConfig(max_depth=3)
    a = _converged(scene, camera, cfg, use_bdpt=False, spp=768)
    b = _converged(scene, camera, cfg, use_bdpt=True, spp=768)
    rel = np.abs(a - b).mean() / max(a.mean(), 1e-9)
    print(f"directional: rel {rel:.4f}, means {b.mean():.5f} / {a.mean():.5f}")
    assert np.isfinite(b).all()
    assert rel < 0.05, rel
    assert abs(a.mean() - b.mean()) / a.mean() < 0.03


def test_bdpt_occlusion_chunking_equivalence(cornell, monkeypatch):
    """Occlusion queries of about two strategies each give the one-query
    result."""
    _, (scene, camera) = cornell
    from mcrt_tpu_torch.camera.pinhole import pixel_uv

    cfg = IntegratorConfig(max_depth=3)
    o, d = camera.generate_rays(pixel_uv(W, W, device="cpu"))
    isect = build_intersector(scene, RenderConfig(width=W, height=W))
    calls = []

    def occluded(s, r):
        calls.append(r.n)
        return isect.occluded(s, r)

    def run():
        calls.clear()
        with torch.no_grad():
            return bdpt.trace(scene, camera, Rays.make(o, d),
                              rng.make_stream(SamplerConfig(), 0, torch.arange(N)), cfg,
                              isect.intersect, occluded)

    one, one_calls = run(), list(calls)
    monkeypatch.setattr(bdpt, "OCC_CHUNK_RAYS", 2 * N)
    many, many_calls = run(), list(calls)
    s0, s1, conn, t1 = bdpt.strategy_pairs(cfg.max_depth)
    staged = len(s1) + len(conn) + len(t1)
    assert one_calls == [staged * N]
    assert many_calls == [2 * N] * (staged // 2) + [N] * (staged % 2)
    np.testing.assert_allclose(one.numpy(), many.numpy(), atol=1e-6)
