"""The port's brute-force oracle (``mcrt_tpu_torch/accel/brute.py``) against
the JAX package's (``mcrt_tpu/accel/brute.py``), and the renders and
gradients through ``AccelType.BRUTE`` and ``AccelType.LBVH``.

- ``intersect_brute`` / ``occluded_brute`` against the JAX oracle on
  ``cornell_box`` and the 500-triangle soup of ``tests/test_lbvh.py``,
  with a chunk size that leaves a partial last chunk: hit and occlusion
  flags and prim ids equal (both take the first triangle of least t), t
  within rtol 1e-6 and atol 1e-7 and u, v within 1e-5 (the JAX package's
  CPU backend fuses multiply-adds, the port's arithmetic does not; see
  ``tests/test_torch_lbvh.py``).
- Chunk sizes 7, 64, 256 and the default give identical results.
- The ports of ``tests/test_intersect_brute.py``: against its float64
  numpy oracle, occlusion consistent with the closest hit, ``tmax``
  respected.
- The barycentrics of the oracle's and the LBVH's hits carry the rays'
  gradient the blocked queries' ``_resolve_uv`` gives.
- ``Renderer`` renders (16x16, depth 3, Sobol, 1 spp) under ``BRUTE`` and
  ``LBVH`` against the JAX ``Renderer`` under the same accel: at least
  ``MIN_AGREE`` of pixels agree at rtol 1e-3 / atol 1e-4.
- ``material_params`` gradients on ``cornell_box`` under the port's
  ``BRUTE`` against ``jax.grad`` under the JAX ``BRUTE``, at
  ``tests/test_torch_diff.py``'s ``TOL``.
"""
import numpy as np
import pytest
import torch

import mcrt_tpu
from mcrt_tpu.accel.brute import intersect_brute as j_intersect_brute
from mcrt_tpu.accel.brute import occluded_brute as j_occluded_brute
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.scene import builders as jb
from mcrt_tpu_torch import Renderer
from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.accel.brute import intersect_brute, occluded_brute
from mcrt_tpu_torch.config import (AccelType, IntegratorConfig, RenderConfig, SamplerConfig,
                                   SamplerType)
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.scene import builders as tbuild
from tests.test_intersect_brute import numpy_closest_hit
from tests.test_lbvh import _random_soup_scene
from tests.test_torch_blocked import both_rays, port_scene, random_ray_arrays
from tests.test_torch_diff import TOL, grads_both
from tests.test_torch_render import MIN_AGREE, _camera

torch.set_num_threads(1)

N_RAYS = 1000
T_RTOL, T_ATOL, UV_ATOL = 1e-6, 1e-7, 1e-5
SCENES = {"cornell_box": lambda: jb.cornell_box()[0], "soup500": lambda: _random_soup_scene(500)}


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    """(name, jax scene, port scene, jax rays, port rays, jax hit, jax
    occlusion)."""
    jscene = SCENES[request.param]()
    jr, tr = both_rays(random_ray_arrays(jscene, N_RAYS, seed=41))
    return (request.param, jscene, port_scene(jscene), jr, tr,
            j_intersect_brute(jscene.geometry, jr), j_occluded_brute(jscene.geometry, jr))


def test_brute_matches_jax(case):
    name, jscene, tscene, _, tr, jh, jo = case
    chunk = 7 if name == "cornell_box" else 96
    assert tscene.geometry.num_faces % chunk  # a partial last chunk
    th = intersect_brute(tscene.geometry, tr, chunk=chunk)
    to = occluded_brute(tscene.geometry, tr, chunk=chunk)
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_array_equal(th.shape.numpy(), np.asarray(jh.shape))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(th.t.numpy()[valid], np.asarray(jh.t)[valid], rtol=T_RTOL,
                               atol=T_ATOL)
    np.testing.assert_array_equal(th.t.numpy()[~valid], np.asarray(jh.t)[~valid])
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                                   rtol=0.0, atol=UV_ATOL, err_msg=f)
    assert valid.sum() > 50 and np.asarray(jo).sum() > 50
    assert not th.valid[~tr.active].any() and not to[~tr.active].any()


def test_chunk_size_does_not_change_the_answer(case):
    _, _, tscene, _, tr, _, _ = case
    ref = intersect_brute(tscene.geometry, tr)
    ref_o = occluded_brute(tscene.geometry, tr)
    for chunk in (7, 64, 256):
        h = intersect_brute(tscene.geometry, tr, chunk=chunk)
        for f in ("t", "prim", "shape", "u", "v", "valid"):
            assert torch.equal(getattr(h, f), getattr(ref, f)), (chunk, f)
        assert torch.equal(occluded_brute(tscene.geometry, tr, chunk=chunk), ref_o), chunk


def _cornell():
    return tbuild.cornell_box(device="cpu")[0]


def test_brute_matches_numpy_oracle():
    """``tests/test_intersect_brute.py``'s seeded rays inside the box
    against its float64 all-triangles oracle."""
    scene = _cornell()
    rng = np.random.default_rng(0xABCDEF12)
    n = 512
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.05, 1.9, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = intersect_brute(scene.geometry, Rays.make(torch.from_numpy(o), torch.from_numpy(d)))
    g = scene.geometry
    ref_t, ref_i = numpy_closest_hit(g.positions.numpy().astype(np.float64), g.indices.numpy(),
                                     g.face_valid.numpy(), o.astype(np.float64),
                                     d.astype(np.float64), np.zeros(n),
                                     np.full(n, np.finfo(np.float32).max))
    assert (ref_i >= 0).mean() > 0.8
    agree = hit.prim.numpy() == ref_i
    assert agree.mean() > 0.98, agree.mean()
    np.testing.assert_allclose(hit.t.numpy()[agree], ref_t[agree], rtol=1e-3, atol=1e-4)


def test_occlusion_consistent_with_closest_hit():
    scene = _cornell()
    rng = np.random.default_rng(1234)
    n = 256
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rng.uniform(-0.9, 0.9, n)
    o[:, 1] = rng.uniform(0.1, 1.9, n)
    o[:, 2] = rng.uniform(-0.9, 0.9, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Rays.make(torch.from_numpy(o), torch.from_numpy(d))
    hit = intersect_brute(scene.geometry, rays)
    np.testing.assert_array_equal(occluded_brute(scene.geometry, rays).numpy(),
                                  hit.valid.numpy())


def test_tmax_respected():
    scene = _cornell()
    o = torch.tensor([[0.0, 1.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]])
    short = Rays.make(o, d, tmax=torch.tensor([0.5]))
    assert not bool(intersect_brute(scene.geometry, short).valid[0])
    assert not bool(occluded_brute(scene.geometry, short)[0])
    h = intersect_brute(scene.geometry, Rays.make(o, d))
    assert bool(h.valid[0]) and abs(float(h.t[0]) - 1.0) < 1e-4


def _uv_grads(isect, scene, arrays):
    o, d, tmin, tmax, active = (torch.from_numpy(a.copy()) for a in arrays)
    rays = Rays(o=o.requires_grad_(), d=d.requires_grad_(), tmin=tmin, tmax=tmax, active=active)
    h = isect.intersect(scene, rays)
    go, gd = torch.autograd.grad((h.u + 2.0 * h.v).sum(), (rays.o, rays.d))
    return h, go.numpy(), gd.numpy()


@pytest.mark.parametrize("accel", [AccelType.BRUTE, AccelType.LBVH])
def test_uv_carries_the_rays_gradient_of_the_blocked_query(accel):
    """d(u + 2v)/d(origin, direction) equal to the blocked query's on every
    ray that hits the same triangle; the values equal the query's without
    a graph."""
    jscene = jb.glass_gallery()[0]
    scene = port_scene(jscene)
    arrays = random_ray_arrays(jscene, 500, seed=43)
    h, go, gd = _uv_grads(build_intersector(scene, RenderConfig(accel=accel)), scene, arrays)
    h0, go0, gd0 = _uv_grads(build_intersector(scene, RenderConfig()), scene, arrays)
    same = (h.prim == h0.prim).numpy() & h.valid.numpy()
    assert same.sum() >= 0.99 * int(h.valid.sum()) and same.sum() > 50
    for g, g0 in ((go, go0), (gd, gd0)):
        assert np.abs(g0).max() > 0
        np.testing.assert_allclose(g[same], g0[same], rtol=1e-4,
                                   atol=1e-6 * float(np.abs(g0).max()))
    _, tr = both_rays(arrays)
    with torch.no_grad():
        plain = build_intersector(scene, RenderConfig(accel=accel)).intersect(scene, tr)
    assert torch.equal(plain.u, h.u.detach()) and torch.equal(plain.v, h.v.detach())


@pytest.mark.parametrize("accel", ["BRUTE", "LBVH"])
def test_renders_match_jax_renderer(accel):
    jscene, jcam = jb.cornell_box()
    jcfg = mcrt_tpu.RenderConfig(width=16, height=16, spp=1, accel=JAccelType[accel],
                                 sampler=JSamplerConfig(type=JSamplerType.SOBOL),
                                 integrator=JIntegratorConfig(max_depth=3))
    cfg = RenderConfig(width=16, height=16, spp=1, accel=AccelType[accel],
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=3))
    r = Renderer(port_scene(jscene), _camera(jcam), cfg, device="cpu")
    img = r.render().numpy()
    jimg = np.asarray(mcrt_tpu.Renderer(jscene, jcam, jcfg).render())
    share = np.isclose(img, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    print(f"{accel}: pixels agreeing {share:.4f}")
    assert share >= MIN_AGREE and np.isfinite(img).all() and img.mean() > 0.0
    assert (r.intersector.accel is None) == (accel == "BRUTE")


def test_material_grads_under_brute_match_jax():
    jscene, jcam = jb.cornell_box()
    share, grads = grads_both(jscene, jcam, "material_params", 16, 16, 2, JAccelType.BRUTE,
                              AccelType.BRUTE)
    assert share >= MIN_AGREE, share
    for k, (t, j) in grads.items():
        rtol, atol = TOL[k]
        err = np.abs(t - j)
        assert np.isfinite(t).all(), k
        assert (err <= rtol * np.abs(j) + atol * float(np.abs(j).max())).all(), (k, err.max())
    assert float(np.abs(grads["diffuse"][0]).sum()) > 0
