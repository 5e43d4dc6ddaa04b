"""The port's LBVH (``mcrt_tpu_torch/accel/lbvh.py``, ``traverse.py``)
against the JAX package's (``mcrt_tpu/accel/lbvh.py``, ``traverse.py``).

- ``_clz32``'s and ``morton3d``'s cases of ``tests/test_lbvh.py`` (and
  every 10-bit input of ``_expand_bits10``) equal to the JAX functions.
- ``build_lbvh`` equal to the JAX build field for field on ``cornell_box``,
  the 500-triangle soup and the duplicate-centroid scene of
  ``tests/test_lbvh.py``, at leaf sizes 2 (the unified table) and 4 (the
  split tables): the build is integers and float min/max, and both sorts
  are stable, so every field must be equal.
- ``intersect_bvh`` / ``occluded_bvh`` against the JAX queries, on the JAX
  tables carried across by ``interop.lbvh_from_numpy`` and on the port's
  own build, over seeded rays (10% inactive, half of them segments): hit
  and occlusion flags equal, t within rtol 1e-6 and atol 1e-7 (the JAX
  package's CPU backend fuses multiply-adds, the port's arithmetic does
  not: the products in t = (e2 . q) / det differ in their last bits, which
  near t = 0, where those products of size ~1 cancel, is up to 6e-8 of t's
  absolute value on these scenes), prim ids equal on more
  than 97% of hits (a shared-edge tie may pick either triangle); the
  coherence-chunked path (``chunk > 0``) too, and equal to the unchunked
  port bit for bit.
- ``traversal_iterations`` equal to the JAX diagnostic: the lockstep count
  and every ray's visits.
- The gather/scatter stack bit-equal to the JAX package's one-hot push and
  pop, at a stack depth of 2, where pushes overflow.
- Gradients through ``AccelType.LBVH`` finite and nonzero (the port of
  ``tests/test_diff.py``'s LBVH case).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu.accel import lbvh as jl
from mcrt_tpu.accel import traverse as jt
from mcrt_tpu.config import BVHConfig as JBVHConfig
from mcrt_tpu.scene.builders import cornell_box as j_cornell_box
from mcrt_tpu.scene.scene import UberMaterial, build_scene
from mcrt_tpu_torch import interop
from mcrt_tpu_torch.accel import lbvh as tl
from mcrt_tpu_torch.accel import traverse as tt
from mcrt_tpu_torch.config import AccelType, BVHConfig, IntegratorConfig, RenderConfig
from mcrt_tpu_torch.core.types import Rays
from tests.test_lbvh import _random_soup_scene
from tests.test_torch_blocked import both_rays, port_scene, random_ray_arrays

torch.set_num_threads(1)

FIELDS = ("node_min", "node_max", "left", "right", "prim", "prim_valid", "packed_t",
          "children", "leaf_t", "unified_t", "unified_ci")
N_RAYS = 1000
T_RTOL, T_ATOL = 1e-6, 1e-7
MIN_SAME_PRIM = 0.97


def _duplicate_centroids():
    """``tests/test_lbvh.py``'s 64 triangles that share one centroid."""
    rng = np.random.default_rng(3)
    n_tris = 64
    offs = rng.normal(scale=0.3, size=(n_tris, 3, 3)).astype(np.float32)
    offs -= offs.mean(1, keepdims=True)
    pos = offs.reshape(-1, 3)
    idx = np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3)
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (len(pos), 1))
    uv = np.zeros((len(pos), 2), np.float32)
    return build_scene(pos, nrm, uv, idx, np.zeros((n_tris,), np.int32), np.asarray([0]),
                       [UberMaterial()])


SCENES = {"cornell_box": lambda: j_cornell_box()[0], "soup500": lambda: _random_soup_scene(500),
          "duplicate_centroids": _duplicate_centroids}


@functools.lru_cache(maxsize=None)
def _scene(name):
    jscene = SCENES[name]()
    return jscene, port_scene(jscene)


@functools.lru_cache(maxsize=None)
def _builds(name, k):
    """(name, jax scene, port scene, leaf size, jax build, port build)."""
    jscene, tscene = _scene(name)
    return (name, jscene, tscene, k, jl.build_lbvh(jscene.geometry, JBVHConfig(max_leaf_size=k)),
            tl.build_lbvh(tscene.geometry, BVHConfig(max_leaf_size=k)))


@functools.lru_cache(maxsize=None)
def _jax_queries(name, k, seed, chunk=0):
    """The JAX hits and occlusion of ``N_RAYS`` seeded rays."""
    _, jscene, _, _, jbvh, _ = _builds(name, k)
    jr, _ = both_rays(random_ray_arrays(jscene, N_RAYS, seed))
    jcfg = JBVHConfig(max_leaf_size=k)
    return (jt.intersect_bvh(jscene.geometry, jbvh, jr, jcfg, chunk=chunk),
            jt.occluded_bvh(jscene.geometry, jbvh, jr, jcfg, chunk=chunk))


@pytest.fixture(params=list(SCENES))
def scene(request):
    return (request.param, *_scene(request.param))


@pytest.fixture(params=[2, 4], ids=["leaf2", "leaf4"])
def builds(request, scene):
    return _builds(scene[0], request.param)


@pytest.fixture(params=[2, 4], ids=["leaf2", "leaf4"])
def soup_builds(request):
    """The soup's builds: the chunked walk and the shallow stack are tested
    on it alone (its tree is the deepest of the three)."""
    return _builds("soup500", request.param)


def _crossed(jbvh):
    return interop.lbvh_from_numpy(*(None if getattr(jbvh, f) is None
                                     else np.asarray(getattr(jbvh, f)) for f in FIELDS),
                                   leaf_size=jbvh.leaf_size, device="cpu")


def test_clz32_equal_jax():
    x = [0, 1, 2, 3, 0x80000000, 0xFFFFFFFF, 0x00010000]
    got = tl._clz32(torch.tensor(x, dtype=torch.int64)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl._clz32(jnp.asarray(x, jnp.uint32))))
    np.testing.assert_array_equal(got, [32, 31, 30, 30, 0, 0, 15])


def test_morton_codes_equal_jax():
    v = np.arange(1024)
    np.testing.assert_array_equal(tl._expand_bits10(torch.from_numpy(v)).numpy(),
                                  np.asarray(jl._expand_bits10(jnp.asarray(v, jnp.uint32))))
    diag = np.linspace(0, 1, 16, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
    pts = np.random.default_rng(5).uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    for p in (diag, pts):
        got = tl.morton3d(torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jl.morton3d(jnp.asarray(p))))
    assert (np.diff(tl.morton3d(torch.from_numpy(diag)).numpy()) >= 0).all()


def test_build_equals_jax(builds):
    name, _, _, k, jbvh, tbvh = builds
    for f in FIELDS:
        a, b = getattr(jbvh, f), getattr(tbvh, f)
        if a is None:
            assert b is None and k != 2, f
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{name} {f}")
    assert tbvh.leaf_size == jbvh.leaf_size and (tbvh.unified is not None) == (k == 2)
    assert 1 <= tbvh.fit_iterations <= tbvh.num_nodes and tbvh.fit_syncs >= 2


def test_fit_iterations_are_the_fixpoint_steps(builds):
    """The fit's count: after ``fit_iterations - 1`` steps a box still
    changes, after ``fit_iterations`` none does."""
    *_, tbvh = builds
    n = tbvh.num_leaves
    start_min = torch.cat([torch.full((n - 1, 3), tl.F32_MAX), tbvh.node_min[n - 1:]])
    start_max = torch.cat([torch.full((n - 1, 3), -tl.F32_MAX), tbvh.node_max[n - 1:]])
    li, ri = tbvh.left.long(), tbvh.right.long()

    def steps(k):
        lo, hi = start_min, start_max
        for _ in range(k):
            lo = torch.cat([torch.minimum(lo[li], lo[ri]), lo[n - 1:]])
            hi = torch.cat([torch.maximum(hi[li], hi[ri]), hi[n - 1:]])
        return lo, hi

    before = steps(tbvh.fit_iterations - 2)
    last = steps(tbvh.fit_iterations - 1)
    assert torch.equal(last[0], tbvh.node_min) and torch.equal(last[1], tbvh.node_max)
    if tbvh.fit_iterations >= 2:
        assert not (torch.equal(before[0], last[0]) and torch.equal(before[1], last[1]))


def _compare(th, to, jh, jo, label):
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), valid, err_msg=label)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=label)
    np.testing.assert_allclose(th.t.numpy()[valid], np.asarray(jh.t)[valid], rtol=T_RTOL,
                               atol=T_ATOL, err_msg=label)
    same = (th.prim.numpy()[valid] == np.asarray(jh.prim)[valid]).mean()
    assert same > MIN_SAME_PRIM, (label, same)
    assert valid.sum() > 50 and np.asarray(jo).sum() > 50, label


@pytest.mark.parametrize("tables", ["jax_tables", "port_build"])
def test_queries_match_jax(builds, tables):
    name, jscene, tscene, k, jbvh, tbvh = builds
    bvh = _crossed(jbvh) if tables == "jax_tables" else tbvh
    _, tr = both_rays(random_ray_arrays(jscene, N_RAYS, seed=17))
    cfg = BVHConfig(max_leaf_size=k)
    _compare(tt.intersect_bvh(tscene.geometry, bvh, tr, cfg),
             tt.occluded_bvh(tscene.geometry, bvh, tr, cfg), *_jax_queries(name, k, 17),
             f"{name} leaf{k} {tables}")


def test_chunked_queries_match_jax_and_the_whole_walk(soup_builds):
    name, jscene, tscene, k, _, tbvh = soup_builds
    _, tr = both_rays(random_ray_arrays(jscene, N_RAYS, seed=23))
    cfg = BVHConfig(max_leaf_size=k)
    th = tt.intersect_bvh(tscene.geometry, tbvh, tr, cfg, chunk=96)  # a padded last chunk
    to = tt.occluded_bvh(tscene.geometry, tbvh, tr, cfg, chunk=96)
    _compare(th, to, *_jax_queries(name, k, 23, chunk=96), f"{name} leaf{k}")
    whole = tt.intersect_bvh(tscene.geometry, tbvh, tr, cfg)
    for f in ("t", "prim", "shape", "u", "v", "valid"):
        assert torch.equal(getattr(th, f), getattr(whole, f)), f
    assert torch.equal(to, tt.occluded_bvh(tscene.geometry, tbvh, tr, cfg))


def test_coherence_order_equals_jax(scene):
    _, jscene, _ = scene
    jr, tr = both_rays(random_ray_arrays(jscene, N_RAYS, seed=29))
    np.testing.assert_array_equal(tt._coherence_order(tr).numpy(),
                                  np.asarray(jt._coherence_order(jr)))


def test_traversal_iterations_equal_jax(builds):
    _, jscene, _, _, jbvh, tbvh = builds
    jr, tr = both_rays(random_ray_arrays(jscene, N_RAYS, seed=31))
    jiters, jvisits = jt.traversal_iterations(jbvh, jr)
    iters, visits = tt.traversal_iterations(tbvh, tr)
    assert iters == int(jiters) > 0
    np.testing.assert_array_equal(visits.numpy(), np.asarray(jvisits))


def _one_hot_push(stack, sp, value, can_push):
    """The JAX package's (S, N) one-hot push, on the port's (N, S) stack."""
    srange = torch.arange(stack.shape[1], dtype=torch.int32)[None, :]
    return torch.where((srange == sp[:, None]) & can_push[:, None], value[:, None], stack)


def _one_hot_pop(stack, sp):
    srange = torch.arange(stack.shape[1], dtype=torch.int32)[None, :]
    return torch.where(srange == sp[:, None], stack, 0).sum(dim=1, dtype=torch.int32)


def test_gather_stack_equals_one_hot_stack(soup_builds, monkeypatch):
    """At stack depth 2 pushes overflow (the walk drops them and misses
    hits, so the answers differ from depth 64's); the gather/scatter stack
    and the one-hot stack give the same answers bit for bit, and the same
    as the JAX walk at that depth."""
    name, jscene, tscene, k, jbvh, tbvh = soup_builds
    jr, tr = both_rays(random_ray_arrays(jscene, N_RAYS, seed=37))
    shallow, deep = BVHConfig(max_leaf_size=k, stack_depth=2), BVHConfig(max_leaf_size=k)

    def run(cfg):
        return (tt.intersect_bvh(tscene.geometry, tbvh, tr, cfg),
                tt.occluded_bvh(tscene.geometry, tbvh, tr, cfg))

    gathered, full = run(shallow), run(deep)
    with monkeypatch.context() as m:
        m.setattr(tt, "_push", _one_hot_push)
        m.setattr(tt, "_pop", _one_hot_pop)
        one_hot = run(shallow)
    for f in ("t", "prim", "shape", "u", "v", "valid"):
        assert torch.equal(getattr(gathered[0], f), getattr(one_hot[0], f)), f
    assert torch.equal(gathered[1], one_hot[1])
    assert not torch.equal(gathered[0].valid, full[0].valid)  # pushes were dropped
    jcfg = JBVHConfig(max_leaf_size=k, stack_depth=2)
    np.testing.assert_array_equal(gathered[0].valid.numpy(),
                                  np.asarray(jt.intersect_bvh(jscene.geometry, jbvh, jr,
                                                              jcfg).valid))
    np.testing.assert_array_equal(gathered[1].numpy(),
                                  np.asarray(jt.occluded_bvh(jscene.geometry, jbvh, jr, jcfg)))


def test_grads_finite_and_nonzero_with_lbvh():
    """``tests/test_diff.py``'s LBVH case: gradients flow through a render
    whose queries walk the LBVH."""
    from mcrt_tpu_torch.accel import build_intersector
    from mcrt_tpu_torch.diff import estimators as E
    from mcrt_tpu_torch.parallel.render import render_spp_batch
    from mcrt_tpu_torch.scene import builders as tbuild

    scene, camera = tbuild.cornell_box(device="cpu")
    cfg = RenderConfig(width=12, height=12, spp=4, accel=AccelType.LBVH,
                       integrator=IntegratorConfig(max_depth=2))
    isect = build_intersector(scene, cfg)
    assert isinstance(isect.accel, tl.LBVH)
    view = E.material_params()
    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}
    img = render_spp_batch(view.set(scene, params), camera, range(4), cfg, isect)
    grads = torch.autograd.grad(img.sum(), list(params.values()), allow_unused=True)
    for k, g in zip(params, grads):
        assert g is None or bool(torch.isfinite(g).all()), k
    assert float(grads[list(params).index("diffuse")].abs().sum()) > 0


@pytest.mark.parametrize("k", [2, 4])
def test_tree_of_one_leaf_matches_the_oracle(k):
    """A geometry whose faces fill one leaf (the first k faces of a soup;
    ``build_scene`` pads to 128 faces): the root is the leaf, with no
    internal node, on the unified (leaf 2) and the split (leaf 4) tables."""
    from mcrt_tpu_torch.accel.brute import intersect_brute, occluded_brute

    jscene = _random_soup_scene(k, seed=4)
    g = port_scene(jscene).geometry
    g = g.replace(indices=g.indices[:k], face_shape=g.face_shape[:k],
                  face_valid=g.face_valid[:k], face_attrs=g.face_attrs[:k])
    bvh = tl.build_lbvh(g, BVHConfig(max_leaf_size=k))
    assert bvh.num_leaves == 1 and bvh.num_nodes == 1
    rng = np.random.default_rng(47)  # rays aimed at the faces' centroids
    cent = torch.stack(g.face_vertices(torch.arange(k)), 0).mean(0)[rng.integers(0, k, 400)]
    o = cent + torch.from_numpy(rng.normal(size=(400, 3)).astype(np.float32))
    tr = Rays.make(o, torch.nn.functional.normalize(cent - o, dim=1))
    cfg = BVHConfig(max_leaf_size=k)
    h, ref = tt.intersect_bvh(g, bvh, tr, cfg), intersect_brute(g, tr)
    for f in ("t", "prim", "valid"):
        assert torch.equal(getattr(h, f), getattr(ref, f)), f
    assert torch.equal(tt.occluded_bvh(g, bvh, tr, cfg), occluded_brute(g, tr))
    assert int(h.valid.sum()) > 100
    assert tt.traversal_iterations(bvh, tr)[0] == 1


def test_fixed_iterations_and_iterations_after_the_end(soup_builds):
    """``_traverse(fixed_iters=k)`` against the JAX loop of k steps (a
    walk cut short), and iterations run after every ray is done change
    nothing (why the loop may test its end only every ``SYNC_EVERY``
    steps): the whole walk plus 13 steps equals the whole walk bit for
    bit."""
    name, jscene, tscene, k, jbvh, tbvh = soup_builds
    jr, tr = both_rays(random_ray_arrays(jscene, N_RAYS, seed=53))
    got = tt._traverse(tbvh, tr, 64, False, fixed_iters=40)
    ref = jt._traverse(jbvh, jr, 64, False, fixed_iters=40)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=T_RTOL, atol=T_ATOL)
    iters, _ = tt.traversal_iterations(tbvh, tr)
    for any_hit in (False, True):
        whole = tt._traverse(tbvh, tr, 64, any_hit)
        longer = tt._traverse(tbvh, tr, 64, any_hit, fixed_iters=iters + 13)
        for a, b in zip(whole, longer):
            assert torch.equal(a, b)
