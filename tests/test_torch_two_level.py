"""The port's two-level (instanced) intersector
(``mcrt_tpu_torch/accel/two_level.py``, the plain versions of kernels
K6/K7 behind K1's plain version) and instanced scenes against the JAX
package.

Build tables are integers or copies of the same float32 values: equal.
Visit lists are equal.  Hit flags and blocked flags are equal and hit
distances agree at the ``T_TOL`` of ``test_torch_blocked.py`` against the
JAX package's pair-list Pallas kernels (interpret mode); against its
per-instance loop oracle, which intersects object-space rays and so rounds
differently, at rtol 1e-5 / atol 1e-5 (that oracle's own tolerance in
``tests/test_two_level.py``).  Shape ids agree on at least 99% of hits
(coincident faces of overlapping instances may tie).  Renders agree per
pixel on at least 99% of pixels at rtol 1e-3 / atol 1e-4.
"""
import numpy as np
import pytest
import torch

import mcrt_tpu
from mcrt_tpu.accel import pallas_blocked as jpb
from mcrt_tpu.accel import two_level as jtl
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.scene import dynamic as jdyn
from mcrt_tpu_torch import Renderer, interop
from mcrt_tpu_torch.accel import blocked as tb
from mcrt_tpu_torch.accel import kernels
from mcrt_tpu_torch.accel import two_level as ttl
from mcrt_tpu_torch.config import (AccelType, IntegratorConfig, RenderConfig, SamplerConfig,
                                   SamplerType)
from mcrt_tpu_torch.scene import builders as tbuild
from tests.test_torch_blocked import T_TOL, both_rays, brute_least_visits, port_scene
from tests.test_torch_render import _camera

# one torch thread per test process (see test_torch_blocked.py)
torch.set_num_threads(1)

BLAS_TABLES = ("tri", "aabb", "slot_prim", "bounds", "chunk_aabb")
TABLES = ("world_to_object", "tw_rows", "shape_id", "pair_aabb", "pair_chunk",
          "pair_code", "bounds")


def _grid_scene(subdiv, n=10):
    """An icosphere added once and placed in n*n grid cells by no-bake
    instances (the source itself fills the first cell), with the JAX
    package's builders."""
    sb = jb.SceneBuffers()
    pos, idx, nrm = jb.icosphere((0.0, 0.0, 0.0), 0.4, subdiv=subdiv)
    src = sb.add_mesh(pos, idx, 0, normals=nrm)
    for k in range(1, n * n):
        sb.add_instanced(src, 0, jdyn.translation((k % n * 1.2, 0.0, k // n * 1.2)))
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    tw, instances = sb.instance_table()
    return jb.build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                          [jb.UberMaterial(diffuse=(0.5,) * 3)], shape_to_world=tw,
                          instances=instances)


CASES = {
    "instanced_boxes": lambda: jb.instanced_boxes(3)[0],
    "grid100": lambda: _grid_scene(subdiv=1),  # 100 instances, 1 block each
    "grid100_big": lambda: _grid_scene(subdiv=4),  # 6,400 pairs: the (key, id) sort
}


def _rays(jscene, n, seed):
    """Rays from inside the scene box in random directions, 10% inactive,
    half with a segment tmax."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(jscene.center) - np.asarray(jscene.radius), \
        np.asarray(jscene.center) + np.asarray(jscene.radius)
    o = rng.uniform(lo * 0.7, hi * 0.7, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.05, 1.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.5, 1e30, rng.uniform(0.05, 3.0, n)).astype(np.float32)
    return both_rays((o, d, np.full((n,), 1e-4, np.float32), tmax, rng.random(n) > 0.1))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, jax scene, jax accel, port scene, port accel)."""
    jscene = CASES[request.param]()
    tscene = port_scene(jscene)
    jacc = jtl.build_two_level_scene(jscene.geometry, jscene.shapes.to_world, jscene.instances)
    tacc = ttl.build_two_level_scene(tscene.geometry, tscene.shapes.to_world, tscene.instances)
    return request.param, jscene, jacc, tscene, tacc


def _assert_tables_equal(tacc, jacc):
    for k in BLAS_TABLES:
        np.testing.assert_array_equal(getattr(tacc.blas, k).numpy(),
                                      np.asarray(getattr(jacc.blas, k)), err_msg=k)
    for k in TABLES:
        np.testing.assert_array_equal(getattr(tacc, k).numpy(), np.asarray(getattr(jacc, k)),
                                      err_msg=k)
    assert (tacc.num_instances, tacc.num_pairs, tacc.blas.num_blocks) == \
        (jacc.num_instances, jacc.num_pairs, jacc.blas.num_blocks)


def test_build_two_level_scene_tables_equal(case):
    name, _, jacc, _, tacc = case
    _assert_tables_equal(tacc, jacc)
    if name == "grid100_big":
        assert tacc.pair_code.shape[0] > tb.PACKED_KEY_MAX_BLOCKS


def test_build_two_level_tables_equal():
    """The single-source builder, as ``tests/test_two_level.py`` uses it."""
    jscene = _grid_scene(subdiv=2, n=3)
    tscene = port_scene(jscene)
    tw = np.stack([jdyn.translation((x, 0.0, 0.5 * x)) @ jdyn.rotation_y(x)
                   @ jdyn.scale((1.0, 0.5 + x, 1.0)) for x in (0.0, 0.7, 1.9)])
    ids = np.asarray([3, 7, 9], np.int32)
    _assert_tables_equal(ttl.build_two_level(tscene.geometry, tw, ids),
                         jtl.build_two_level(jscene.geometry, tw, ids))


def test_pair_visit_lists_equal(case):
    """K1's plain version over the pair boxes at the JAX package's tile of
    256, then the visit-list sort, against ``_visit_lists`` in interpret
    mode."""
    _, jscene, jacc, _, tacc = case
    jr, tr = _rays(jscene, 1000, seed=21)
    jpacked = jpb._pack_rays(jr)
    tpacked = tb._pack_table(tb._ray_table(tr))
    keys = tb.cull_plain(tpacked, tacc.pair_chunk, tacc.pair_aabb, 256)
    jlists = jpb._visit_lists(jpacked, jacc.pair_chunk, jacc.pair_aabb, True)
    for a, b, what in zip(tb.lists_from_keys(keys), jlists, ("counts", "lists", "tn_sorted")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)
    assert int(np.asarray(jlists[0]).sum()) > 0


def _check(th, to, jh, jo, t_tol, name):
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), valid, err_msg=name)
    np.testing.assert_allclose(th.t.numpy()[valid], np.asarray(jh.t)[valid], **t_tol,
                               err_msg=name)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=name)
    assert (th.shape.numpy()[valid] == np.asarray(jh.shape)[valid]).mean() >= 0.99, name


def test_two_level_queries_match_jax(case):
    name, jscene, jacc, tscene, tacc = case
    jr, tr = _rays(jscene, 1000, seed=5)
    th = ttl.intersect_two_level(tscene.geometry, tacc, tr)
    to = ttl.occluded_two_level(tscene.geometry, tacc, tr)
    _check(th, to, jtl.intersect_two_level(jscene.geometry, jacc, jr),
           jtl.occluded_two_level(jscene.geometry, jacc, jr), T_TOL, "pallas")
    if name == "grid100":
        # the per-instance loop oracle holds for a single BLAS
        _check(th, to, jtl.intersect_two_level_loop(jscene.geometry, jacc, jr),
               jtl.occluded_two_level_loop(jscene.geometry, jacc, jr),
               dict(rtol=1e-5, atol=1e-5), "loop")
    assert int(th.valid.sum()) > 50 and int(to.sum()) > 50
    assert not th.valid[~tr.active].any() and not to[~tr.active].any()


def test_interop_two_level_accel_gives_the_same_hits(case):
    _, jscene, jacc, tscene, tacc = case
    blas = interop.blocked_accel_from_numpy(
        *(np.asarray(getattr(jacc.blas, k)) for k in BLAS_TABLES),
        num_blocks=jacc.blas.num_blocks, device="cpu")
    crossed = interop.two_level_accel_from_numpy(
        blas, *(np.asarray(getattr(jacc, k)) for k in TABLES),
        num_instances=jacc.num_instances, num_pairs=jacc.num_pairs, device="cpu")
    _, tr = _rays(jscene, 300, seed=8)
    a = ttl.intersect_two_level(tscene.geometry, crossed, tr)
    b = ttl.intersect_two_level(tscene.geometry, tacc, tr)
    np.testing.assert_array_equal(a.t.numpy(), b.t.numpy())
    np.testing.assert_array_equal(a.shape.numpy(), b.shape.numpy())


@pytest.mark.parametrize("name", ["instanced_boxes", "sphere_field_instanced"])
def test_instanced_builders_match_jax(name):
    """The port's instanced builders give the scene the JAX package's
    builders give (``sphere_field_instanced`` written with them here)."""
    if name == "instanced_boxes":
        jscene = jb.instanced_boxes(3)[0]
        own = tbuild.instanced_boxes(3, device="cpu")[0]
    else:
        sb = jb.SceneBuffers()
        fp, fi = jb.quad([-5.0, 0, 5.0], [5.0, 0, 5.0], [5.0, 0, -5.0], [-5.0, 0, -5.0])
        sb.add_mesh(fp, fi, 0)
        unit_p, unit_i, unit_n = jb.icosphere((0.0, 0.0, 0.0), 0.6, subdiv=1)
        c = [np.asarray([(k % 4 - 1.5) * 1.6, 0.6, (k // 4 - 1.0) * 1.6], np.float32)
             for k in range(12)]
        src = sb.add_mesh(unit_p + c[0], unit_i, 1, normals=unit_n)
        for k in range(1, 12):
            sb.add_instanced(src, 1 + k % 3, jdyn.translation(c[k] - c[0]))
        lp, li = jb.quad([-1.5, 4.0, -1.5], [1.5, 4.0, -1.5], [1.5, 4.0, 1.5],
                         [-1.5, 4.0, 1.5])
        light_shape = sb.add_mesh(lp, li, 4, light_id=0)
        positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
        tw, instances = sb.instance_table()
        lights = jb.make_lights([{"type": jb.LIGHT_MESH, "intensity": (14.0, 13.0, 12.0),
                                  "shape": light_shape}], positions, indices, face_shape)
        jscene = jb.build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                                [jb.UberMaterial(**vars(m)) for m in tbuild.GALLERY_MATERIALS],
                                lights=lights, shape_light=shape_light,
                                shape_to_world=tw, instances=instances)
        own = tbuild.sphere_field_instanced(subdiv=1, device="cpu")[0]
        assert own.instances.num == 11 and int(own.geometry.face_valid.sum()) == 84
    crossed = port_scene(jscene)
    for group in ("geometry", "shapes", "materials", "lights", "instances"):
        for field, v in vars(getattr(crossed, group)).items():
            if isinstance(v, torch.Tensor):
                np.testing.assert_array_equal(getattr(getattr(own, group), field).numpy(),
                                              v.numpy(), err_msg=f"{group}.{field}")
    assert own.geometry.instanced and crossed.geometry.instanced
    assert (own.instances.face_lo, own.instances.face_hi) == \
        (tuple(jscene.instances.face_lo), tuple(jscene.instances.face_hi))
    np.testing.assert_array_equal(own.center.numpy(), np.asarray(jscene.center))


def _cfg(size=32, **kw):
    return RenderConfig(width=size, height=size, spp=1,
                        sampler=SamplerConfig(type=SamplerType.SOBOL),
                        integrator=IntegratorConfig(max_depth=3), **kw)


def _agreement(a, b):
    return np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1).mean()


def test_instanced_boxes_render_agrees_with_jax():
    """1-spp 32x32 Sobol renders through each package's ``AccelType.AUTO``
    (the two-level engine for an instanced scene)."""
    jscene, jcam = jb.instanced_boxes(3)
    jimg = np.asarray(mcrt_tpu.Renderer(jscene, jcam, mcrt_tpu.RenderConfig(
        width=32, height=32, spp=1, sampler=JSamplerConfig(type=JSamplerType.SOBOL),
        integrator=JIntegratorConfig(max_depth=3))).render())
    r = Renderer(port_scene(jscene), _camera(jcam), _cfg(), device="cpu")
    assert isinstance(r.intersector.accel, ttl.TwoLevelAccel)
    timg = r.render().numpy()
    share = _agreement(timg, jimg)
    print(f"instanced_boxes: 1 spp per-pixel mismatch share {1.0 - share:.5f}")
    assert share >= 0.99 and np.isfinite(timg).all() and timg.mean() > 0.02


def test_sphere_field_instanced_renders_as_the_baked_scene():
    """The instanced and baked forms of the same content (subdiv 1) give
    the same image: their world positions differ only by float rounding."""
    imgs = [Renderer(*build(subdiv=1, device="cpu"), _cfg(16), device="cpu").render().numpy()
            for build in (tbuild.sphere_field_instanced, tbuild.sphere_field)]
    assert _agreement(*imgs) >= 0.99 and imgs[0].mean() > 0.0


def test_accel_selection_for_instanced_and_flat_scenes():
    """AUTO and TWO_LEVEL take the two-level engine for an instanced scene
    and the other accels refuse it; TWO_LEVEL on a scene without instances
    renders it as one free BLAS under an identity instance, as BLOCKED
    does."""
    scene, cam = tbuild.instanced_boxes(2, device="cpu")
    r = Renderer(scene, cam, _cfg(8, accel=AccelType.TWO_LEVEL), device="cpu")
    assert isinstance(r.intersector.accel, ttl.TwoLevelAccel)
    with pytest.raises(ValueError, match="instanced"):
        Renderer(scene, cam, _cfg(8, accel=AccelType.BLOCKED), device="cpu")
    flat, fcam = tbuild.cornell_box(device="cpu")
    two = Renderer(flat, fcam, _cfg(16, accel=AccelType.TWO_LEVEL), device="cpu")
    acc = two.intersector.accel
    assert isinstance(acc, ttl.TwoLevelAccel) and acc.num_instances == 1
    assert int(acc.shape_id[0]) == -1
    blocked = Renderer(flat, fcam, _cfg(16, accel=AccelType.BLOCKED), device="cpu")
    assert _agreement(two.render().numpy(), blocked.render().numpy()) >= 0.99


def test_two_level_wrappers_take_cuda_tensors_only(case):
    _, jscene, _, _, tacc = case
    _, tr = _rays(jscene, 200, seed=4)
    packed, _ = tb._sorted_table(tr, tacc, True)
    counts, lists, tn = ttl.pair_lists(packed, tacc)
    kernels.reset_launch_counts()
    for dev in ("cpu", "meta"):
        p, c, ls, t, tri, code, tw, box = (x.to(dev) for x in (
            packed, counts, lists, tn, tacc.blas.tri, tacc.pair_code, tacc.tw_rows,
            tacc.pair_aabb))
        with pytest.raises(ValueError, match="CUDA"):
            kernels.closest2(c, p, ls, t, tri, code, tw, box, tb.TILE, tb.GROUP)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.occluded2(c, p, ls, tri, code, tw, box, tb.TILE, tb.GROUP)
    assert not any(kernels.launch_counts().values())


def test_plain_pair_walk_does_not_depend_on_tile_and_group(case):
    """The plain K6/K7 at other tile widths and group sizes (the kernels take
    both; the card tests run them at these values) give the same results as
    at the port's TILE/GROUP."""
    _, jscene, _, _, tacc = case
    _, tr = _rays(jscene, 1000, seed=6)
    packed, _ = tb._sorted_table(tr, tacc, True)  # 1024 columns

    def run(tile, group):
        keys = tb.cull_plain(packed, tacc.pair_chunk, tacc.pair_aabb, tile)
        counts, lists, tn = tb.lists_from_keys(keys)
        args = (tacc.blas.tri, tacc.pair_code, tacc.tw_rows, tile, group)
        return (*ttl.closest2_plain(counts, packed, lists, tn, *args),
                ttl.occluded2_plain(counts, packed, lists, *args))

    ref = run(tb.TILE, tb.GROUP)
    for a, b in zip(run(256, 1), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int((ref[1] >= 0).sum()) > 50 and (ref[2][ref[1] >= 0] >= 0).all()


# walk_tests of K6 (closest) and K7 on 1,000 rays of each case, as the tile
# walk counted them before K2/K3 gained their own counts (walk_work).
PAIR_WALK_TESTS = {
    "instanced_boxes": ((923648, 7680), (754688, 7680)),
    "grid100": ((3741696, 29696), (3125760, 29696)),
    "grid100_big": ((18892800, 148992), (15482368, 148992)),
}


def test_pair_walk_counts_are_unchanged(case):
    """K6/K7's bound keeps the tile walk's count (``walk_tests`` through
    ``pair_rows``), which shares ``_walk_plain`` with K2/K3."""
    name, jscene, _, _, tacc = case
    _, tr = _rays(jscene, 1000, seed=6)
    packed, _ = tb._sorted_table(tr, tacc, True)
    counts, lists, tn = ttl.pair_lists(packed, tacc)
    rows = ttl.pair_rows(tacc.blas.tri, tacc.pair_code, tacc.tw_rows)
    got = (tb.walk_tests(counts, packed, lists, tn, rows, tb.TILE, tb.GROUP, True),
           tb.walk_tests(counts, packed, lists, None, rows, tb.TILE, tb.GROUP, False))
    assert got == PAIR_WALK_TESTS[name]


def _pair_work(tacc, packed, tile, group, closest):
    """(lists, tile walk tests, per-ray floor, warp visits) of K6 (``closest``)
    or K7 on these rays."""
    counts, lists, tn = tb.lists_from_keys(
        tb.cull_plain(packed, tacc.pair_chunk, tacc.pair_aabb, tile))
    rows = ttl.pair_rows(tacc.blas.tri, tacc.pair_code, tacc.tw_rows)
    tests, _ = tb.walk_tests(counts, packed, lists, tn if closest else None, rows, tile, group,
                             closest)
    least, warp = tb.walk_work(counts, packed, lists, tn, rows, tacc.pair_aabb, tile, group,
                               closest)
    return (counts, lists, tn), tests, least, warp


@pytest.mark.parametrize("closest", [True, False])
def test_least_pair_walk_work_equals_a_brute_loop(case, closest):
    """K6/K7's per-ray floor (``walk_work`` over ``pair_rows`` and
    ``pair_aabb``) on 40 rays equals the count of a loop over rays and
    list entries."""
    _, jscene, _, _, tacc = case
    _, tr = _rays(jscene, 40, seed=33)
    packed, _ = tb._sorted_table(tr, tacc, True)
    (counts, lists, tn), _, least, warp = _pair_work(tacc, packed, tb.TILE, tb.GROUP, closest)
    rows = ttl.pair_rows(tacc.blas.tri, tacc.pair_code, tacc.tw_rows)
    t_final = ttl.closest2_plain(counts, packed, lists, tn, tacc.blas.tri, tacc.pair_code,
                                 tacc.tw_rows)[0]
    assert least == brute_least_visits(tacc.pair_aabb, rows, packed, counts, lists, t_final,
                                       tb.TILE, closest)
    assert 0 < least and 0 < warp <= int(counts.sum()) * tb.TILE // 32


@pytest.mark.parametrize("closest", [True, False])
def test_pair_walk_work_is_at_most_the_tile_walk(case, closest):
    """K6/K7's warp visits cover the per-ray floor and never exceed the
    tests of the tile walk, at the port's tile and group and at another."""
    _, jscene, _, _, tacc = case
    _, tr = _rays(jscene, 1000, seed=34)
    packed, _ = tb._sorted_table(tr, tacc, True)
    found = []
    for tile, group in ((tb.TILE, tb.GROUP), (64, 3)):
        _, tests, least, warp = _pair_work(tacc, packed, tile, group, closest)
        assert 0 < least * tb.BLOCK <= warp * 32 * tb.BLOCK <= tests
        found.append(least)
    assert found[0] == found[1] or not closest
