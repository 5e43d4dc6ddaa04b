"""The port's sharded-scene ray ring (``parallel/ring.py``) on gloo ranks
(the CPU) against the JAX package's ring on its virtual CPU devices and
its brute-force oracle, as ``tests/test_ring.py`` tests the JAX ring.

- ``shard_faces`` (n = 2, 4 and 8) and the stacked shard tables of
  ``_build_shard_accels`` (n = 2 and 4) equal the JAX package's, NaNs in
  the same places: on ``cornell_box``, ``glass_gallery`` and a
  72,000-triangle soup whose shards hold more than 128 blocks (several
  cull-chunk rows).
- At world sizes 2 and 4, on ``cornell_box`` (each shard on the dense
  path) and ``glass_gallery`` (a shard of more than 8 blocks takes the
  visit-list path), the ring's closest hit against the JAX brute oracle
  (hit flags equal, t within rtol 1e-5 / atol 1e-6, the hit point on the
  ray) and its occlusion (equal on 512 seeded rays); the PT and BDPT
  samples through the ring against the port's replicated render (rtol
  1e-4 / atol 1e-5, as the JAX test holds its ring) and, on
  ``cornell_box``, against the JAX ring's samples at the parity share
  (0.99 of pixels within rtol 1e-3 / atol 1e-4); ``render_spp_batch`` and
  ``make_train_step`` through the ring on a (1, n) mesh against the
  unsharded port; the gradient of the ring's barycentrics with respect
  to the rays against the replicated intersector's.
- Refusals: an instanced scene (``ValueError``), ``use_blocked=False``
  (the brute oracle is not ported), and rays that do not divide over the
  rays axis (``ValueError``).

The JAX package is imported inside the helpers that use it: the ranks
import this module and need only the port.
"""
import numpy as np
import pytest
import torch

from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.parallel.mesh import spawn_ranks
from mcrt_tpu_torch.parallel.render import make_train_step, render_spp_batch
from mcrt_tpu_torch.parallel.ring import _build_shard_accels, shard_faces
from mcrt_tpu_torch.renderer import render_sample
from tests.test_torch_parallel import _cfg, _raises, jax_leaves, port_of

torch.set_num_threads(1)

WORLDS = (2, 4)
SCENES = ("cornell_box", "glass_gallery")
PT_SIZE, BDPT_SIZE, N_OCC = 32, 16, 512
TABLES = ("tri", "aabb", "chunk_aabb", "slot_prim", "bounds")
SOUP_TRIS = 72000  # shards of more than 128 blocks at n = 4


def _rays(arrays) -> Rays:
    o, d, tmin, tmax, active = (torch.from_numpy(np.array(a)) for a in arrays)
    return Rays(o=o, d=d, tmin=tmin, tmax=tmax, active=active)


def _render(scene, cam, integrator, isect):
    size = PT_SIZE if integrator == "PATH" else BDPT_SIZE
    with torch.no_grad():
        return render_sample(scene, cam, 0, _cfg(integrator, size), isect)[0].numpy()


def _step(scene, cam, isect, mesh):
    from mcrt_tpu_torch.diff import estimators as E

    cfg = _cfg(size=BDPT_SIZE)
    with torch.no_grad():
        target = render_spp_batch(scene, cam, (100, 101), cfg, isect) * 0.8
    view = E.full_params()
    loss, grads = make_train_step(cam, cfg, isect, mesh, view.get, view.set)(scene, (0, 1),
                                                                              target)
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def _uv_grads(scene, isect, arrays):
    """(prim, d(u + 2v)/d origin, d(u + 2v)/d direction) of the closest hits
    of ``arrays``' rays."""
    rays = _rays(arrays)
    rays = rays.replace(o=rays.o.requires_grad_(), d=rays.d.requires_grad_())
    h = isect.intersect(scene, rays)
    go, gd = torch.autograd.grad((h.u + 2.0 * h.v).sum(), (rays.o, rays.d))
    return h.prim.numpy(), go.numpy(), gd.numpy()


def rank_ring(rank, world, inputs, out_dir):
    """Every ring case on a (1, world) mesh; each rank saves its results
    to ``out_dir/rank<r>.pt``."""
    from mcrt_tpu_torch.parallel.mesh import make_mesh
    from mcrt_tpu_torch.parallel.ring import build_sharded_scene

    mesh = make_mesh(1, world, device="cpu")
    out = {}
    for name in SCENES:
        scene, cam = port_of(inputs[name]["leaves"])
        sscene, ring = build_sharded_scene(scene, mesh)
        res = out[name] = {}
        with torch.no_grad():
            h = ring.intersect(sscene, _rays(inputs[name]["camera_rays"]))
            p0, p1, p2 = sscene.geometry.face_vertices(h.prim.clamp_min(0))
            w = 1.0 - h.u - h.v
            res["point"] = (w[:, None] * p0 + h.u[:, None] * p1 + h.v[:, None] * p2).numpy()
            res["hit"] = {k: getattr(h, k).numpy() for k in ("t", "prim", "u", "v", "valid")}
            res["occluded"] = ring.occluded(sscene, _rays(inputs[name]["occ_rays"])).numpy()
            res["odd_rays"] = _raises(ValueError, lambda: ring.occluded(
                sscene, _rays([a[:N_OCC - 1] for a in inputs[name]["occ_rays"]])))
            res["num_blocks"] = ring.accel.num_blocks
            for integ in ("PATH", "BDPT"):
                res[integ] = _render(sscene, cam, integ, ring)
            res["batch"] = render_spp_batch(sscene, cam, (0, 1), _cfg(), ring, mesh).numpy()
        res["step"] = _step(sscene, cam, ring, mesh)
        res["uv_grad"] = _uv_grads(sscene, ring, inputs[name]["camera_rays"])
        res["uv_grad_replicated"] = _uv_grads(sscene, build_intersector(sscene, _cfg()),
                                              inputs[name]["camera_rays"])
    iscene, _ = port_of(inputs["instanced_boxes"])
    out["instanced"] = _raises(ValueError, lambda: build_sharded_scene(iscene, mesh))
    out["brute"] = _raises(NotImplementedError, lambda: build_sharded_scene(
        port_of(inputs["cornell_box"]["leaves"])[0], mesh, use_blocked=False))
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def _jax_scene(name):
    from mcrt_tpu.scene import builders as jb

    return getattr(jb, name)()


def _jax_inputs():
    """Per scene: the numpy leaves, 32x32 camera rays, 512 seeded rays, and
    the JAX brute oracle's answers on them."""
    import jax.numpy as jnp

    from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
    from mcrt_tpu.camera.pinhole import pixel_uv
    from mcrt_tpu.core.types import Rays as JRays
    from tests.test_torch_blocked import random_ray_arrays

    inputs = {"instanced_boxes": jax_leaves(*_jax_scene("instanced_boxes"))}
    for name in SCENES:
        jscene, jcam = _jax_scene(name)
        o, d = jcam.generate_rays(pixel_uv(PT_SIZE, PT_SIZE))
        cam_rays = JRays.make(o, d)
        occ = random_ray_arrays(jscene, N_OCC, 11)
        occ_rays = JRays(*(jnp.asarray(a) for a in occ))
        h = intersect_brute(jscene.geometry, cam_rays)
        inputs[name] = {
            "leaves": jax_leaves(jscene, jcam),
            "camera_rays": [np.asarray(a) for a in (cam_rays.o, cam_rays.d, cam_rays.tmin,
                                                    cam_rays.tmax, cam_rays.active)],
            "occ_rays": list(occ),
            "oracle_hit": {k: np.asarray(getattr(h, k)) for k in ("t", "valid")},
            "oracle_occluded": np.asarray(occluded_brute(jscene.geometry, occ_rays))}
    return inputs


def _jax_ring_samples():
    """The JAX ring's (brute per shard) PT and BDPT samples of
    ``cornell_box`` on (1, n) meshes of its virtual devices."""
    import jax
    import jax.numpy as jnp

    import mcrt_tpu
    from mcrt_tpu.config import IntegratorConfig as JIC
    from mcrt_tpu.config import IntegratorType as JIT
    from mcrt_tpu.parallel.mesh import make_mesh as j_make_mesh
    from mcrt_tpu.parallel.ring import build_sharded_scene as j_shard
    from mcrt_tpu.renderer import render_sample as j_render_sample

    jscene, jcam = _jax_scene("cornell_box")
    out = {}
    for n in WORLDS:
        sscene, ring = j_shard(jscene, j_make_mesh(1, n, devices=jax.devices()[:n]),
                               use_blocked=False)
        for integ in ("PATH", "BDPT"):
            size = PT_SIZE if integ == "PATH" else BDPT_SIZE
            cfg = mcrt_tpu.RenderConfig(width=size, height=size,
                                        integrator=JIC(type=JIT[integ], max_depth=2))
            r, _ = jax.jit(lambda s, f: j_render_sample(s, jcam, f, cfg, ring))(
                sscene, jnp.asarray(0))
            out[n, integ] = np.asarray(r)
    return out


def _spawn(inputs, tmp_dir):
    results = {}
    for world in WORLDS:
        d = tmp_dir / f"world{world}"
        d.mkdir()
        spawn_ranks(rank_ring, world, args=(world, inputs, str(d)), device="cpu",
                    init_method=f"file://{d}/store", timeout=300)
        results[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                          for r in range(world)]
    return results


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """(inputs, the ranks' results, the JAX ring's samples): the ranks run
    in their own processes while this one computes the JAX ring."""
    from concurrent.futures import ThreadPoolExecutor

    inputs = _jax_inputs()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn, inputs, tmp_path_factory.mktemp("ring"))
        jax_ring = _jax_ring_samples()
        return inputs, ranks.result(), jax_ring


@pytest.fixture(scope="module")
def replicated(ring_run):
    """The port's replicated renders, batch and step of each scene."""
    inputs = ring_run[0]
    out = {}
    for name in SCENES:
        scene, cam = port_of(inputs[name]["leaves"])
        isect = build_intersector(scene, _cfg())
        out[name] = {integ: _render(scene, cam, integ, isect) for integ in ("PATH", "BDPT")}
        with torch.no_grad():
            out[name]["batch"] = render_spp_batch(scene, cam, (0, 1), _cfg(), isect).numpy()
        out[name]["step"] = _step(scene, cam, isect, None)
    return out


# ------------------------------------------------------------------ tables


def _geometries(name):
    """(JAX geometry, the port's crossed over through ``interop``)."""
    from tests.test_lbvh import _random_soup_scene
    from tests.test_torch_blocked import port_scene

    jscene = (_random_soup_scene(n_tris=SOUP_TRIS, seed=5) if name == "soup"
              else _jax_scene(name)[0])
    return jscene.geometry, port_scene(jscene).geometry


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", SCENES)
def test_shard_faces_equal_jax(name, n):
    from mcrt_tpu.parallel.ring import shard_faces as j_shard_faces

    jgeom, tgeom = _geometries(name)
    jg, jmap = j_shard_faces(jgeom, n, return_face_map=True)
    tg, tmap = shard_faces(tgeom, n, return_face_map=True)
    for k in ("indices", "face_shape", "face_valid", "face_attrs"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(tmap, jmap)
    assert int(tg.face_valid.sum()) == int(tgeom.face_valid.sum())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", SCENES + ("soup",))
def test_shard_tables_equal_jax(name, n):
    from mcrt_tpu.parallel.ring import _build_shard_accels as j_build
    from mcrt_tpu.parallel.ring import shard_faces as j_shard_faces

    jgeom, tgeom = _geometries(name)
    jg = j_shard_faces(jgeom, n)
    tg = shard_faces(tgeom, n)
    fpad = tg.indices.shape[0] // n
    jacc = j_build(jg, n, fpad)
    tacc = _build_shard_accels(tg, n, fpad)
    assert tacc.num_blocks == jacc.num_blocks
    for k in TABLES:  # NaN boxes in the same places
        np.testing.assert_array_equal(getattr(tacc, k).numpy(), np.asarray(getattr(jacc, k)),
                                      err_msg=k)
    if name == "soup":  # shards of more than 128 blocks: several chunk rows
        assert tacc.chunk_aabb.shape[1] > 1 and tacc.num_blocks > 128


# ------------------------------------------------------------------ ring


def _per_rank(ring_run, world, name):
    return [r[name] for r in ring_run[1][world]]


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_closest_hit_matches_oracle(ring_run, world, name):
    inputs = ring_run[0][name]
    ref = inputs["oracle_hit"]
    o = inputs["camera_rays"][0]
    for r in _per_rank(ring_run, world, name):  # every rank returns the global hits
        h = r["hit"]
        np.testing.assert_array_equal(h["valid"], ref["valid"])
        np.testing.assert_allclose(np.where(h["valid"], h["t"], 0.0),
                                   np.where(ref["valid"], ref["t"], 0.0), rtol=1e-5, atol=1e-6)
        # the ring's prim indexes the sharded tables: its barycentric point
        # lies on the ray at t (ties between coplanar triangles may differ)
        t_re = np.linalg.norm(r["point"] - o, axis=-1)
        ok = ~h["valid"] | np.isclose(t_re, h["t"], rtol=1e-3, atol=1e-3)
        assert ok.all()
        assert h["valid"].sum() > 0


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_occlusion_matches_oracle(ring_run, world, name):
    ref = ring_run[0][name]["oracle_occluded"]
    assert ref.sum() > 50
    for r in _per_rank(ring_run, world, name):
        np.testing.assert_array_equal(r["occluded"], ref)
        assert r["odd_rays"] and "do not divide" in r["odd_rays"]


@pytest.mark.parametrize("integrator", ["PATH", "BDPT"])
@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_render_equals_replicated(ring_run, replicated, world, name, integrator):
    ref = replicated[name][integrator]
    assert np.isfinite(ref).all() and ref.mean() > 0
    for r in _per_rank(ring_run, world, name):
        np.testing.assert_allclose(r[integrator], ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("integrator", ["PATH", "BDPT"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_render_matches_jax_ring(ring_run, world, integrator):
    jimg = ring_run[2][world, integrator]
    img = _per_rank(ring_run, world, "cornell_box")[0][integrator]
    share = np.isclose(img, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= 0.99, share


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_batch_and_step_equal_unsharded(ring_run, replicated, world, name):
    ref = replicated[name]
    loss0, g0 = ref["step"]
    for r in _per_rank(ring_run, world, name):
        np.testing.assert_allclose(r["batch"], ref["batch"], rtol=1e-5, atol=1e-6)
        loss, g = r["step"]
        assert np.isclose(loss, loss0, rtol=1e-5, atol=0.0), (loss, loss0)
        for k, v in g0.items():
            np.testing.assert_allclose(g[k], v, rtol=1e-4,
                                       atol=1e-6 * float(np.abs(v).max()), err_msg=k)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_hit_carries_the_rays_gradient(ring_run, world, name):
    """The ring's u, v are differentiable in the rays, as the replicated
    query's are (its exchange carries no graph): the gradients of
    sum(u + 2v) with respect to the rays' origins and directions equal the
    replicated intersector's over the same sharded faces on every ray that
    hits the same triangle (all but coplanar ties)."""
    for r in _per_rank(ring_run, world, name):
        prim, go, gd = r["uv_grad"]
        prim0, go0, gd0 = r["uv_grad_replicated"]
        same = prim == prim0
        assert same.mean() >= 0.99, same.mean()
        for g, g0 in ((go, go0), (gd, gd0)):
            assert np.abs(g0).max() > 0
            np.testing.assert_allclose(g[same], g0[same], rtol=1e-4,
                                       atol=1e-6 * float(np.abs(g0).max()))


@pytest.mark.parametrize("world", WORLDS)
def test_ring_refusals(ring_run, world):
    for r in ring_run[1][world]:
        assert r["instanced"] and "instanced" in r["instanced"]
        assert r["brute"] and "brute" in r["brute"] and "Queue 1" in r["brute"]


def test_list_path_shards(ring_run):
    """``glass_gallery``'s two shards take the visit-list path (more than 8
    blocks), ``cornell_box``'s the dense one."""
    assert _per_rank(ring_run, 2, "glass_gallery")[0]["num_blocks"] > 8
    assert _per_rank(ring_run, 4, "cornell_box")[0]["num_blocks"] <= 8
