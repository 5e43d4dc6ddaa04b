"""The port's blocked intersector (``mcrt_tpu_torch/accel/blocked.py``, the
module that holds kernels K1-K3) against the JAX package.

On the CPU the port's queries run the kernels' plain PyTorch versions, and
the JAX package's run its Pallas kernels in interpret mode.  Build tables,
the coherence permutation, cull keys and visit lists are integers or copies
of the same float32 values, so they must be equal.  Hit distances are
compared at rtol 1e-5 / atol 1e-6 (the JAX tests' own tolerance), and
hit/miss and blocked flags must be equal.  Primitive ids are not compared:
coplanar ties may pick different triangles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu.accel import pallas_blocked as jpb
from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
from mcrt_tpu.config import BuilderType as JBuilderType
from mcrt_tpu.config import BVHConfig as JBVHConfig
from mcrt_tpu.core.types import Rays as JRays
from mcrt_tpu.scene.builders import glass_gallery as jax_glass_gallery
from mcrt_tpu_torch import interop
from mcrt_tpu_torch.accel import blocked as tb
from mcrt_tpu_torch.accel import kernels
from mcrt_tpu_torch.config import BuilderType, BVHConfig
from mcrt_tpu_torch.core.types import Rays
from tests.test_lbvh import _random_soup_scene

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

T_TOL = dict(rtol=1e-5, atol=1e-6)
TABLES = ("tri", "aabb", "slot_prim", "bounds", "chunk_aabb")


def port_scene(jscene):
    """The JAX scene's leaves as numpy arrays, crossed over through
    ``interop.scene_from_numpy``."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(jscene)
    return interop.scene_from_numpy(
        {jax.tree_util.keystr(p).lstrip("."): np.asarray(v) for p, v in leaves})


def random_ray_arrays(jscene, n, seed):
    """Rays from inside the scene box in random directions: 10% inactive,
    half with a segment tmax, tmin 1e-4."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(jscene.geometry.positions)
    lo, hi = pos.min(0), pos.max(0)
    o = (rng.uniform(-1, 1, (n, 3)) * (hi - lo) * 0.45 + (lo + hi) / 2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.5, 1e30, rng.uniform(0.05, 3.0, n)).astype(np.float32)
    active = rng.random(n) > 0.1
    return o, d, np.full((n,), 1e-4, np.float32), tmax, active


def both_rays(arrays):
    o, d, tmin, tmax, active = arrays
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d), tmin=jnp.asarray(tmin),
               tmax=jnp.asarray(tmax), active=jnp.asarray(active))
    tr = Rays(o=torch.from_numpy(o.copy()), d=torch.from_numpy(d.copy()),
              tmin=torch.from_numpy(tmin.copy()), tmax=torch.from_numpy(tmax.copy()),
              active=torch.from_numpy(active.copy()))
    return jr, tr


def _case(name, jscene):
    """(name, jax scene, jax accel, port scene, port accel)."""
    tscene = port_scene(jscene)
    return (name, jscene, jpb.build_blocked(jscene.geometry), tscene,
            tb.build_blocked(tscene.geometry))


@pytest.fixture(scope="module")
def gallery():
    """glass_gallery: 47 blocks, one cull chunk."""
    return _case("glass_gallery", jax_glass_gallery()[0])


@pytest.fixture(scope="module")
def soup():
    """A 20k-triangle soup: more than 128 blocks, so several cull chunks."""
    return _case("soup20k", _random_soup_scene(n_tris=20000, seed=11))


@pytest.fixture(params=["glass_gallery", "soup20k"])
def case(request):
    return request.getfixturevalue("gallery" if request.param == "glass_gallery" else "soup")


def test_build_tables_equal(case):
    name, _, jacc, _, tacc = case
    assert tacc.builder == "sah"
    assert tacc.num_blocks == jacc.num_blocks
    if name == "soup20k":
        assert tacc.num_blocks > 128
    for k in TABLES:
        # assert_array_equal treats NaN as equal to NaN: the poisoned
        # positions must coincide
        np.testing.assert_array_equal(getattr(tacc, k).numpy(),
                                      np.asarray(getattr(jacc, k)), err_msg=k)
    assert np.isnan(tacc.aabb.numpy()).any()


def test_lbvh_build_tables_equal():
    jscene = _random_soup_scene(n_tris=3000, seed=5)
    jacc = jpb.build_blocked(jscene.geometry, JBVHConfig(builder=JBuilderType.LBVH))
    tacc = tb.build_blocked(port_scene(jscene).geometry, BVHConfig(builder=BuilderType.LBVH))
    assert tacc.builder == "lbvh"
    for k in TABLES:
        np.testing.assert_array_equal(getattr(tacc, k).numpy(),
                                      np.asarray(getattr(jacc, k)), err_msg=k)


@pytest.mark.parametrize("n", [1, 1000, 70000])
def test_coherence_order_equal(case, n):
    _, jscene, jacc, _, tacc = case
    jr, tr = both_rays(random_ray_arrays(jscene, n, seed=n))
    j = np.asarray(jpb._coherence_order(jr, jacc.bounds))
    t = tb._coherence_order(tr, tacc.bounds)
    np.testing.assert_array_equal(t.numpy(), j)
    # inactive rays are last
    assert not tr.active[t][int(tr.active.sum()):].any()


def test_cull_keys_and_visit_lists_equal(case):
    """The plain K1 at the JAX package's tile of 256 against ``_cull`` in
    interpret mode (one of its 8 duplicate rows per tile), then the packed
    sort against ``_visit_lists``."""
    _, jscene, jacc, _, tacc = case
    # 1000 rays pad to 1024 columns at the port's tile and at the JAX
    # package's, so the packed tables are the same array
    jr, tr = both_rays(random_ray_arrays(jscene, 1000, seed=21))
    jpacked = jpb._pack_rays(jr)
    tpacked = tb._pack_table(tb._ray_table(tr))
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked))
    jkeys = np.asarray(jpb._cull(jpacked, jacc.chunk_aabb, jacc.aabb, True))[::8]
    tkeys = tb.cull_plain(tpacked, tacc.chunk_aabb, tacc.aabb, 256)
    np.testing.assert_array_equal(tkeys.numpy(), jkeys)
    assert (jkeys < 1e38).any()
    jlists = jpb._visit_lists(jpacked, jacc.chunk_aabb, jacc.aabb, True)
    tlists = tb.lists_from_keys(tkeys)
    for a, b, name in zip(tlists, jlists, ("counts", "lists", "tn_sorted")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _check_hits(jscene, tscene, jacc, tacc, n, seed):
    jr, tr = both_rays(random_ray_arrays(jscene, n, seed))
    th = tb.intersect_blocked(tscene.geometry, tacc, tr)
    to = tb.occluded_blocked(tscene.geometry, tacc, tr)
    refs = {"brute": (intersect_brute(jscene.geometry, jr),
                      occluded_brute(jscene.geometry, jr)),
            "pallas": (jpb.intersect_blocked(jscene.geometry, jacc, jr),
                       jpb.occluded_blocked(jscene.geometry, jacc, jr))}
    for name, (jh, jo) in refs.items():
        valid = np.asarray(jh.valid)
        np.testing.assert_array_equal(th.valid.numpy(), valid, err_msg=name)
        np.testing.assert_allclose(th.t.numpy()[valid], np.asarray(jh.t)[valid],
                                   **T_TOL, err_msg=name)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=name)
    assert not th.valid[~tr.active].any() and not to[~tr.active].any()
    assert (th.shape[th.valid] >= 0).all()
    np.testing.assert_array_equal(th.prim.numpy() >= 0, th.valid.numpy())
    return th, to


@pytest.mark.parametrize("n", [1, 100, 1000])
def test_queries_match_pallas_and_brute(gallery, n):
    _, jscene, jacc, tscene, tacc = gallery
    th, to = _check_hits(jscene, tscene, jacc, tacc, n, seed=100 + n)
    if n == 1000:
        assert int(th.valid.sum()) > 50 and int(to.sum()) > 50


def test_multichunk_queries_match_pallas_and_brute(soup):
    _, jscene, jacc, tscene, tacc = soup
    th, to = _check_hits(jscene, tscene, jacc, tacc, 1000, seed=1100)
    assert int(th.valid.sum()) > 50 and int(to.sum()) > 50


def _plain_walks(tacc, packed, tile, group):
    keys = tb.cull_plain(packed, tacc.chunk_aabb, tacc.aabb, tile)
    counts, lists, tn = tb.lists_from_keys(keys)
    t, slot = tb.closest_plain(counts, packed, lists, tn, tacc.tri, tile, group)
    return t, slot >= 0, tb.occluded_plain(counts, packed, lists, tacc.tri, tile, group)


@pytest.mark.parametrize("tile, group", [(256, 1), (64, 3)])
def test_plain_walks_do_not_depend_on_tile_and_group(case, tile, group):
    """The plain K1-K3 at other tile widths and group sizes (the kernels
    take both; the card tests run them at these values) give the same
    distances and flags as at the port's TILE/GROUP."""
    _, jscene, _, _, tacc = case
    _, tr = both_rays(random_ray_arrays(jscene, 1000, seed=5))
    packed, _ = tb._sorted_table(tr, tacc, True)  # 1024 columns
    ref = _plain_walks(tacc, packed, tb.TILE, tb.GROUP)
    for a, b in zip(_plain_walks(tacc, packed, tile, group), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(ref[1].sum()) > 50


def test_interop_accel_gives_the_same_hits(case):
    _, jscene, jacc, tscene, tacc = case
    crossed = interop.blocked_accel_from_numpy(
        *(np.asarray(getattr(jacc, k)) for k in TABLES), num_blocks=jacc.num_blocks)
    _, tr = both_rays(random_ray_arrays(jscene, 300, seed=8))
    a = tb.intersect_blocked(tscene.geometry, crossed, tr)
    b = tb.intersect_blocked(tscene.geometry, tacc, tr)
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    np.testing.assert_array_equal(a.t.numpy(), b.t.numpy())


def test_nan_poisoned_block_never_entered(case):
    """A fully NaN-poisoned block gets key BIG for every tile, even from
    rays aimed straight at it, so no visit list holds it."""
    _, jscene, _, tscene, tacc = case
    b = 3
    lo, hi = tacc.aabb[b, 0:3], tacc.aabb[b, 3:6]
    n = 256
    target = lo + (hi - lo) * torch.rand((n, 3), generator=torch.Generator().manual_seed(0))
    o = (tacc.bounds[1] + 1.0).expand(n, 3).contiguous()
    d = target - o
    rays = Rays.make(o, d / d.norm(dim=1, keepdim=True))
    packed = tb._pack_table(tb._ray_table(rays))
    before = tb.cull_plain(packed, tacc.chunk_aabb, tacc.aabb)
    assert (before[:, b] < 0.5 * tb.BIG).all()
    poisoned = tacc.replace(aabb=tacc.aabb.clone())
    poisoned.aabb[b, 0:6] = float("nan")
    keys = tb.cull_plain(packed, tacc.chunk_aabb, poisoned.aabb)
    assert (keys[:, b] == tb.BIG).all()
    counts, lists, _ = tb.lists_from_keys(keys)
    for row, c in zip(lists, counts):
        assert b not in row[:int(c)].tolist()


def test_wrappers_take_plain_versions_on_cpu_only(case):
    """On CPU tensors the queries run the plain versions and count no
    launch; the kernel wrappers themselves take CUDA tensors only and raise
    on any other device."""
    _, jscene, _, tscene, tacc = case
    _, tr = both_rays(random_ray_arrays(jscene, 200, seed=4))
    kernels.reset_launch_counts()
    tb.intersect_blocked(tscene.geometry, tacc, tr)
    tb.occluded_blocked(tscene.geometry, tacc, tr)
    assert kernels.launch_counts() == {"K1": 0, "K2": 0, "K3": 0}
    packed, _ = tb._sorted_table(tr, tacc, True)
    counts, lists, tn = tb.lists_from_keys(tb.cull_plain(packed, tacc.chunk_aabb, tacc.aabb))
    for dev in ("cpu", "meta"):
        p, c, ls, t, tri = (x.to(dev) for x in (packed, counts, lists, tn, tacc.tri))
        with pytest.raises(ValueError, match="CUDA"):
            kernels.cull(p, tacc.chunk_aabb.to(dev), tacc.aabb.to(dev), tb.TILE)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.closest(c, p, ls, t, tri, tb.TILE, tb.GROUP)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.occluded(c, p, ls, tri, tb.TILE, tb.GROUP)
    assert kernels.launch_counts() == {"K1": 0, "K2": 0, "K3": 0}
