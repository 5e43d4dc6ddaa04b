"""Dynamic scenes in the port (``mcrt_tpu_torch/scene/dynamic.py``, the
refits of ``accel/blocked.py`` and ``accel/two_level.py``,
``Renderer.update_scene``), SBVH blocks and ``render_spp_batch``, against
the JAX package and against the port's own rebuilds.

Tolerances:

- the refit tables (``refit_blocked``; the two-level ``tw_rows``, pair
  boxes, chunk boxes and bounds) and the SBVH references and build tables
  are gathers, subtractions, min/max and (pair boxes) the same float32
  products in the same order as the JAX package's, so given equal inputs
  they are equal bit for bit;
- ``world_to_object`` is an inverse (the port's adjugate, the JAX
  package's LU solve): rtol 1e-6;
- ``SceneAnimator.transformed`` positions, normals, light CDFs and areas:
  allclose 1e-5 (products summed in another order);
- refit against rebuild: closest-hit t at rtol 1e-5 / atol 1e-6 and equal
  hit flags, animated frames at rtol 1e-4 / atol 1e-5 (the JAX package's
  own tests' tolerances);
- renders against the JAX package's: at least 99% of pixels within rtol
  1e-3 / atol 1e-4 (a flipped decision changes a whole pixel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcrt_tpu
from mcrt_tpu.accel import pallas_blocked as jpb
from mcrt_tpu.accel import two_level as jtl
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import BuilderType as JBuilderType
from mcrt_tpu.config import BVHConfig as JBVHConfig
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.parallel.render import render_spp_batch as j_render_spp_batch
from mcrt_tpu.runtime import native as jnative
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.scene import dynamic as jd
from mcrt_tpu_torch import Renderer
from mcrt_tpu_torch.accel import blocked as tb
from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.accel import two_level as ttl
from mcrt_tpu_torch.config import (AccelType, BuilderType, BVHConfig, IntegratorConfig,
                                   RenderConfig, SamplerConfig, SamplerType)
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.film.accumulate import Accumulator
from mcrt_tpu_torch.parallel.render import render_spp_batch
from mcrt_tpu_torch.renderer import render_sample
from mcrt_tpu_torch.runtime import native as tnative
from mcrt_tpu_torch.scene import builders as tbuild
from mcrt_tpu_torch.scene.dynamic import (SceneAnimator, make_animated_frame, rotation_y,
                                          scale, set_shape_transform, translation,
                                          vertex_shape_ids)
from mcrt_tpu_torch.scene.scene import LIGHT_MESH
from tests.test_lbvh import _random_soup_scene
from tests.test_torch_blocked import port_scene
from tests.test_torch_render import _camera

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

TALL_BOX = 5  # cornell_box shape ids: 0-4 walls, 5-6 boxes, 7 light
LIGHT_SHAPE = 7
TABLES = ("tri", "aabb", "slot_prim", "bounds", "chunk_aabb")
MIN_AGREE = 0.99
MOVES = {  # scene: (shape, transform) of the edit the JAX comparisons make
    "cornell_box": (TALL_BOX, translation((0.3, 0.1, -0.2)) @ rotation_y(0.7)),
    "glass_gallery": (1, translation((0.4, 0.2, -0.3)) @ rotation_y(0.9)
                      @ scale((1.1, 0.8, 1.0))),
}


def _equal(jarr, tarr) -> bool:
    a, b = np.asarray(jarr), tarr.cpu().numpy()
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


@pytest.fixture(scope="module")
def cornell():
    return tbuild.cornell_box(device="cpu")


@pytest.fixture(scope="module", params=list(MOVES))
def moved(request):
    """(name, jax scene, jax moved scene, transforms) of one edit."""
    name = request.param
    jscene = getattr(jb, name)()[0]
    anim = jd.SceneAnimator.create(jscene)
    t = anim.identity_transforms()
    shape, m = MOVES[name]
    t[shape] = m
    return name, jscene, anim.transformed(jnp.asarray(t)), t


# --------------------------------------------------------------------------
# The port against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("builder", ["SAH", "SBVH"])
def test_refit_blocked_tables_equal_jax(moved, builder):
    """``refit_blocked`` of the same moved geometry: every table equal to
    the JAX package's, bit for bit (on ``glass_gallery``, 47 SAH and 49
    SBVH blocks, and the one-block ``cornell_box``)."""
    _, jscene, jmoved, _ = moved
    jacc = jpb.build_blocked(jscene.geometry, JBVHConfig(builder=JBuilderType[builder]))
    tacc = tb.build_blocked(port_scene(jscene).geometry, BVHConfig(builder=BuilderType[builder]))
    assert tacc.num_blocks == jacc.num_blocks
    jref = jpb.refit_blocked(jacc, jmoved.geometry)
    tref = tb.refit_blocked(tacc, port_scene(jmoved).geometry)
    for k in TABLES:
        assert _equal(getattr(jref, k), getattr(tref, k)), k
    assert torch.equal(tref.slot_prim, tacc.slot_prim) and tref.num_blocks == tacc.num_blocks
    assert not torch.equal(tref.tri, tacc.tri)  # the edit moved triangles


def test_refit_of_unmoved_geometry_equals_the_build(moved):
    """With nothing moved, a refit gives back the build's own tables."""
    _, jscene, _, _ = moved
    geom = port_scene(jscene).geometry
    acc = tb.build_blocked(geom)
    ref = tb.refit_blocked(acc, geom)
    for k in TABLES:
        assert torch.equal(torch.nan_to_num(getattr(ref, k), nan=7.0),
                           torch.nan_to_num(getattr(acc, k), nan=7.0)), k


def test_animator_transformed_matches_jax(moved):
    """``SceneAnimator.transformed``: vertex shape ids equal, positions,
    normals, light CDFs and areas within 1e-5 of the JAX package's, and the
    base's ``indices`` and ``face_valid`` tensors shared, not copied."""
    _, jscene, jmoved, t = moved
    base = port_scene(jscene)
    anim = SceneAnimator.create(base)
    assert _equal(jd.vertex_shape_ids(jscene), anim.vertex_shape)
    out = anim.transformed(t)
    for jv, tv in ((jmoved.geometry.positions, out.geometry.positions),
                   (jmoved.geometry.normals, out.geometry.normals),
                   (jmoved.geometry.face_attrs, out.geometry.face_attrs),
                   (jmoved.lights.tri_cdf, out.lights.tri_cdf),
                   (jmoved.lights.area, out.lights.area),
                   (jmoved.shapes.to_world, out.shapes.to_world),
                   (jmoved.shapes.normal_mat, out.shapes.normal_mat),
                   (jmoved.center, out.center), (jmoved.radius, out.radius)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert out.geometry.indices is base.geometry.indices
    assert out.geometry.face_valid is base.geometry.face_valid
    # from a tensor as from a host array
    again = anim.transformed(torch.from_numpy(t))
    assert torch.equal(again.geometry.positions, out.geometry.positions)


@pytest.fixture(scope="module")
def instanced():
    """(jax scene, jax accel, port scene, port accel, moved instance's shape,
    its new transform) on ``instanced_boxes``."""
    jscene = jb.instanced_boxes()[0]
    jacc = jtl.build_two_level_scene(jscene.geometry, jscene.shapes.to_world,
                                     jscene.instances)
    tscene = port_scene(jscene)
    tacc = ttl.build_two_level_scene(tscene.geometry, tscene.shapes.to_world,
                                     tscene.instances)
    m = translation((0.5, 0.2, -0.3)) @ rotation_y(1.1) @ scale((1.2, 0.7, 1.0))
    return jscene, jacc, tscene, tacc, int(jscene.instances.shape[2]), m


def test_refit_two_level_matches_jax(instanced):
    """``refit_two_level_scene`` after ``set_shape_transform``: ``tw_rows``,
    pair boxes, chunk boxes and bounds equal to the JAX package's bit for
    bit, ``world_to_object`` within rtol 1e-6, the pair decomposition kept."""
    jscene, jacc, tscene, tacc, sid, m = instanced
    jmoved = jd.set_shape_transform(jscene, sid, m)
    tmoved = set_shape_transform(tscene, sid, m)
    np.testing.assert_allclose(tmoved.shapes.to_world.numpy(),
                               np.asarray(jmoved.shapes.to_world), rtol=0, atol=0)
    np.testing.assert_allclose(tmoved.shapes.normal_mat.numpy(),
                               np.asarray(jmoved.shapes.normal_mat), rtol=1e-5, atol=1e-6)
    assert tmoved.geometry is tscene.geometry
    jref = jtl.refit_two_level_scene(jacc, jmoved)
    tref = ttl.refit_two_level_scene(tacc, tmoved)
    for k in ("tw_rows", "pair_aabb", "pair_chunk", "bounds", "pair_code", "shape_id"):
        assert _equal(getattr(jref, k), getattr(tref, k)), k
    np.testing.assert_allclose(tref.world_to_object.numpy(), np.asarray(jref.world_to_object),
                               rtol=1e-6)
    assert tref.blas is tacc.blas and tref.num_pairs == tacc.num_pairs
    assert not torch.equal(tref.tw_rows, tacc.tw_rows)


def test_refit_two_level_of_unmoved_instances_equals_the_build(instanced):
    """Refitted from the build's own transforms, the two-level tables are
    the build's (the host build's numpy products round alike here)."""
    _, _, tscene, tacc, _, _ = instanced
    ref = ttl.refit_two_level_scene(tacc, tscene)
    for k in ("tw_rows", "pair_aabb", "pair_chunk", "bounds"):
        assert torch.equal(torch.nan_to_num(getattr(ref, k), nan=7.0),
                           torch.nan_to_num(getattr(tacc, k), nan=7.0)), k
    np.testing.assert_allclose(ref.world_to_object.numpy(), tacc.world_to_object.numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["cornell_box", "glass_gallery", "soup"])
def test_sbvh_block_refs_and_build_equal_jax(name):
    """The native SBVH references through the port's bridge equal the JAX
    package's, and so do the SBVH build tables; in a 2,000-triangle soup
    some triangles are referenced from two blocks."""
    jscene = _random_soup_scene(n_tris=2000, seed=11) if name == "soup" else getattr(jb, name)()[0]
    pos = np.asarray(jscene.geometry.positions)
    tri_idx = np.asarray(jscene.geometry.indices)[np.asarray(jscene.geometry.face_valid)]
    jrefs = jnative.sbvh_block_refs(pos, tri_idx)
    trefs = tnative.sbvh_block_refs(pos, tri_idx)
    for a, b in zip(jrefs, trefs):
        assert np.array_equal(a, b)
    jacc = jpb.build_blocked(jscene.geometry, JBVHConfig(builder=JBuilderType.SBVH))
    tacc = tb.build_blocked(port_scene(jscene).geometry, BVHConfig(builder=BuilderType.SBVH))
    assert tacc.builder == "sbvh" and tacc.num_blocks == jacc.num_blocks
    for k in TABLES:
        assert _equal(getattr(jacc, k), getattr(tacc, k)), k
    if name == "soup":
        assert len(trefs[0]) > len(tri_idx)  # duplicated references


def test_render_spp_batch_matches_jax():
    """``render_spp_batch`` over 2 samples of ``cornell_box`` (16x16, Sobol)
    against the JAX package's: at least 99% of pixels agree."""
    jscene, jcam = jb.cornell_box()
    frames = [3, 4]
    jcfg = mcrt_tpu.RenderConfig(width=16, height=16, accel=JAccelType.BRUTE,
                                 sampler=JSamplerConfig(type=JSamplerType.SOBOL),
                                 integrator=JIntegratorConfig(max_depth=3))
    jimg = np.asarray(j_render_spp_batch(jscene, jcam, jnp.asarray(frames), jcfg,
                                         mcrt_tpu.accel.build_intersector(jscene, jcfg)))
    scene = port_scene(jscene)
    cfg = RenderConfig(width=16, height=16, sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=3))
    timg = render_spp_batch(scene, _camera(jcam), frames, cfg,
                            build_intersector(scene, cfg)).numpy()
    assert timg.shape == jimg.shape == (256, 3)
    share = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= MIN_AGREE and timg.mean() > 0.0


# --------------------------------------------------------------------------
# The port's versions of the JAX package's dynamic-scene tests
# --------------------------------------------------------------------------


def test_identity_transform_is_noop(cornell):
    scene, _ = cornell
    anim = SceneAnimator.create(scene)
    out = anim.transformed(anim.identity_transforms())
    for a, b in ((out.geometry.positions, scene.geometry.positions),
                 (out.geometry.normals, scene.geometry.normals),
                 (out.lights.tri_cdf, scene.lights.tri_cdf)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.lights.area.numpy(), scene.lights.area.numpy(), rtol=1e-5)


def test_translate_moves_only_target_shape(cornell):
    scene, _ = cornell
    out = SceneAnimator.create(scene).set_transform(TALL_BOX, translation((0.25, 0.0, 0.0)))
    vs = vertex_shape_ids(scene).numpy()
    p0, p1 = scene.geometry.positions.numpy(), out.geometry.positions.numpy()
    moved = vs == TALL_BOX
    np.testing.assert_allclose(p1[moved] - p0[moved],
                               np.broadcast_to([0.25, 0, 0], (moved.sum(), 3)), atol=1e-6)
    np.testing.assert_allclose(p1[~moved], p0[~moved], atol=1e-6)
    np.testing.assert_allclose(out.geometry.normals.numpy(), scene.geometry.normals.numpy(),
                               atol=1e-5)


def test_scaled_light_refreshes_area_and_pdf(cornell):
    scene, _ = cornell
    out = SceneAnimator.create(scene).set_transform(LIGHT_SHAPE, scale(2.0))
    assert float(out.lights.area[0]) == pytest.approx(4.0 * float(scene.lights.area[0]),
                                                      rel=1e-4)
    cdf = out.lights.tri_cdf.numpy()
    assert cdf[-1] == pytest.approx(1.0, abs=1e-5)
    assert np.all(np.diff(cdf) >= -1e-6)
    assert int(out.lights.type[0]) == LIGHT_MESH


def test_rotation_preserves_mesh_light_area(cornell):
    scene, _ = cornell
    out = SceneAnimator.create(scene).set_transform(LIGHT_SHAPE, rotation_y(0.7))
    assert float(out.lights.area[0]) == pytest.approx(float(scene.lights.area[0]), rel=1e-4)


def test_add_instance_duplicates_geometry():
    sb = tbuild.SceneBuffers()
    pos, idx = tbuild.box([0, 0, 0], [1, 1, 1])
    src = sb.add_mesh(pos, idx, material_id=0)
    inst = sb.add_instance(src, material_id=0, to_world=translation((3.0, 0.0, 0.0)))
    assert inst == src + 1
    positions, normals, uvs, indices, face_shape, *_ = sb.concat()
    n = len(pos)
    np.testing.assert_allclose(positions[n:] - positions[:n],
                               np.broadcast_to([3, 0, 0], (n, 3)), atol=1e-6)
    np.testing.assert_allclose(normals[n:], normals[:n], atol=1e-6)
    assert indices[face_shape == inst].min() >= n


def test_stop_at_spp(cornell):
    scene, camera = cornell
    r = Renderer(scene, camera, RenderConfig(width=16, height=16, spp=8, stop_at_spp=3,
                                             integrator=IntegratorConfig(max_depth=1)),
                 device="cpu")
    r.render()
    assert r.accum.frame == 3
    r.reset()
    assert r.accum.frame == 0


def test_render_after_transform_changes_image(cornell):
    scene, camera = cornell
    r = Renderer(scene, camera, RenderConfig(width=32, height=32, spp=4, samples_per_pass=4,
                                             integrator=IntegratorConfig(max_depth=2)),
                 device="cpu")
    img0 = r.render().numpy()
    r.update_scene(SceneAnimator.create(r.scene).set_transform(
        TALL_BOX, translation((0.4, 0.0, 0.2))))
    assert r.accum.frame == 0  # accumulation reset
    img1 = r.render().numpy()
    assert np.isfinite(img1).all()
    assert np.abs(img1 - img0).max() > 1e-3


def _random_rays(scene, n=512, seed=3):
    rng = np.random.RandomState(seed)
    pos = scene.geometry.positions.numpy()
    lo, hi = pos.min(0), pos.max(0)
    o = rng.uniform(-1, 1, (n, 3)) * (hi - lo) * 0.7 + (lo + hi) / 2
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays.make(torch.as_tensor(o, dtype=torch.float32),
                     torch.as_tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("name, builder", [("cornell_box", "SAH"), ("glass_gallery", "SAH"),
                                           ("glass_gallery", "SBVH")])
def test_refit_matches_rebuild_conformance(name, builder):
    """``refit_blocked`` (the build's decomposition, moved) gives the same
    closest hits as a rebuild on the moved geometry: the dense path on
    ``cornell_box``, the visit-list path on ``glass_gallery``."""
    scene = getattr(tbuild, name)(device="cpu")[0]
    anim = SceneAnimator.create(scene)
    t = anim.identity_transforms()
    shape, m = MOVES[name]
    t[shape] = m
    moved = anim.transformed(t)
    cfg = BVHConfig(builder=BuilderType[builder])
    refit = tb.refit_blocked(tb.build_blocked(scene.geometry, cfg), moved.geometry)
    rebuilt = tb.build_blocked(moved.geometry, cfg)
    rays = _random_rays(moved)
    sort = refit.num_blocks >= 8
    h_refit = tb.intersect_blocked(moved.geometry, refit, rays, sort=sort)
    h_build = tb.intersect_blocked(moved.geometry, rebuilt, rays, sort=sort)
    assert torch.equal(h_refit.valid, h_build.valid) and int(h_refit.valid.sum()) > 100
    np.testing.assert_allclose(torch.where(h_refit.valid, h_refit.t, 0.0).numpy(),
                               torch.where(h_build.valid, h_build.t, 0.0).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(tb.occluded_blocked(moved.geometry, refit, rays, sort=sort),
                       tb.occluded_blocked(moved.geometry, rebuilt, rays, sort=sort))


@pytest.mark.parametrize("name", ["cornell_box", "glass_gallery"])
def test_animated_frames_fused_refit_match_host_rebuild(name):
    """Frames through ``make_animated_frame`` (transform, refit, render; no
    host build) equal renders of fresh ``Renderer``s that rebuild."""
    scene, camera = getattr(tbuild, name)(device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=1, accel=AccelType.BLOCKED,
                       integrator=IntegratorConfig(max_depth=2))
    anim = SceneAnimator.create(scene)
    frame_fn = make_animated_frame(anim, camera, cfg)
    shape = MOVES[name][0]
    for k in range(3):
        t = anim.identity_transforms()
        t[shape] = rotation_y(0.4 * k)
        accum = Accumulator.zeros(cfg.width, cfg.height, "cpu")
        _, accum = frame_fn(t, accum, accum.frame)
        ref = Renderer(anim.transformed(t), camera, cfg, device="cpu").render(spp=1)
        np.testing.assert_allclose(accum.image.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_renderer_update_scene_refits_without_rebuild(cornell, monkeypatch):
    """A transform-only edit through ``update_scene`` refits (no host
    ``build_blocked``) and renders what a rebuild renders."""
    scene, camera = cornell
    cfg = RenderConfig(width=16, height=16, spp=2, samples_per_pass=2, accel=AccelType.BLOCKED,
                       integrator=IntegratorConfig(max_depth=2))
    r = Renderer(scene, camera, cfg, device="cpu")
    moved = SceneAnimator.create(r.scene).set_transform(TALL_BOX, translation((0.2, 0.0, 0.1)))

    def _boom(*a, **k):
        raise AssertionError("build_blocked called on a transform-only edit")

    monkeypatch.setattr(tb, "build_blocked", _boom)
    r.update_scene(moved)
    img_refit = r.render().numpy()
    monkeypatch.undo()
    img_rebuild = Renderer(moved, camera, cfg, device="cpu").render().numpy()
    np.testing.assert_allclose(img_refit, img_rebuild, atol=1e-5)
    img_orig = Renderer(scene, camera, cfg, device="cpu").render().numpy()
    assert np.abs(img_refit - img_orig).max() > 1e-3


def test_update_scene_refits_instances_without_rebuild(monkeypatch):
    """An instance-only edit (``set_shape_transform``) of ``instanced_boxes``
    takes ``refit_two_level_scene``: no host build, the image of a rebuild,
    and the moved instance's pixels changed (the refit's ``tw_rows`` move
    what the walks test)."""
    scene, camera = tbuild.instanced_boxes(device="cpu")
    cfg = RenderConfig(width=24, height=24, spp=1, sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=2))
    r = Renderer(scene, camera, cfg, device="cpu")
    img_orig = r.render().numpy()
    sid = int(scene.instances.shape[2])
    moved = set_shape_transform(r.scene, sid, translation((-1.0, 0.3, 0.5)) @ rotation_y(0.8))

    def _boom(*a, **k):
        raise AssertionError("a host build ran on an instance-only edit")

    monkeypatch.setattr(ttl, "build_two_level_scene", _boom)
    monkeypatch.setattr(tb, "build_blocked", _boom)
    r.update_scene(moved)
    assert r.accum.frame == 0
    img_refit = r.render().numpy()
    monkeypatch.undo()
    img_rebuild = Renderer(moved, camera, cfg, device="cpu").render().numpy()
    share = np.isclose(img_refit, img_rebuild, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= MIN_AGREE
    changed = ~np.isclose(img_refit, img_orig, rtol=1e-3, atol=1e-4).all(-1)
    assert changed.mean() > 0.01


def test_update_scene_rebuilds_a_new_topology(cornell):
    """A scene with other face tensors is rebuilt, not refitted."""
    scene, camera = cornell
    r = Renderer(scene, camera, RenderConfig(width=8, height=8), device="cpu")
    before = r.intersector.accel
    other = scene.replace(geometry=scene.geometry.replace(indices=scene.geometry.indices.clone()))
    r.update_scene(other)
    assert r.intersector.accel is not before
    assert torch.equal(r.intersector.accel.tri, before.tri)  # rebuilt from the same faces


def test_scene_to_keeps_tensors_already_on_the_device(cornell):
    """``Scene.to`` returns a device's tensors as they are, so a scene made
    from ``Renderer.scene`` keeps the identity ``update_scene`` reads."""
    scene, _ = cornell
    again = scene.to("cpu")
    assert again.geometry.indices is scene.geometry.indices
    assert again.geometry.face_valid is scene.geometry.face_valid
    assert again.lights.tri_cdf is scene.lights.tri_cdf


def test_render_spp_batch_is_the_mean_of_its_samples(cornell):
    """``render_spp_batch`` equals the mean of the same ``render_sample``
    calls made one by one."""
    scene, camera = cornell
    cfg = RenderConfig(width=16, height=16, integrator=IntegratorConfig(max_depth=2))
    inter = build_intersector(scene, cfg)
    frames = np.arange(5, 8)
    out = render_spp_batch(scene, camera, frames, cfg, inter)
    each = torch.stack([render_sample(scene, camera, int(f), cfg, inter)[0] for f in frames])
    assert out.shape == (256, 3)
    assert torch.equal(out, each.mean(0))
