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
    """The JAX scene's leaves as numpy arrays (and an instance registry's
    static face ranges), crossed over through ``interop.scene_from_numpy``
    onto the CPU."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(jscene)
    arrays = {jax.tree_util.keystr(p).lstrip("."): np.asarray(v) for p, v in leaves}
    if jscene.instances is not None:
        arrays["instances.face_lo"] = np.asarray(jscene.instances.face_lo)
        arrays["instances.face_hi"] = np.asarray(jscene.instances.face_hi)
    return interop.scene_from_numpy(arrays, device="cpu")


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
        *(np.asarray(getattr(jacc, k)) for k in TABLES), num_blocks=jacc.num_blocks,
        device="cpu")
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
    assert not any(kernels.launch_counts().values())
    packed, _ = tb._sorted_table(tr, tacc, True)
    counts, lists, tn = tb.lists_from_keys(tb.cull_plain(packed, tacc.chunk_aabb, tacc.aabb))
    for dev in ("cpu", "meta"):
        p, c, ls, t, tri = (x.to(dev) for x in (packed, counts, lists, tn, tacc.tri))
        with pytest.raises(ValueError, match="CUDA"):
            kernels.cull(p, tacc.chunk_aabb.to(dev), tacc.aabb.to(dev), tb.TILE)
        box = tacc.aabb.to(dev)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.closest(c, p, ls, t, tri, box, tb.TILE, tb.GROUP)
        with pytest.raises(ValueError, match="CUDA"):
            kernels.occluded(c, p, ls, tri, box, tb.TILE, tb.GROUP)
    assert not any(kernels.launch_counts().values())


def brute_least_visits(boxes, rows_of, packed, counts, lists, t_final, tile, closest):
    """``walk_work``'s least count, ray by ray and list entry by list entry:
    the entered entries (blocks, or (instance, block) pairs) of the ray's
    list with an entry distance no greater than its final t (closest hit),
    or up to its first blocking entry (any hit).  ``boxes`` is the box
    table the entries index, ``rows_of`` the walk's group loader."""
    total = 0
    for col in range(packed.shape[1]):
        ox, oy, oz, dx, dy, dz, ix, iy, iz, tmn, tmx = tb._ray_rows(packed[:, col, None])
        if not bool(tmx > tmn):
            continue
        row = col // tile
        for p in range(int(counts[row])):
            e = int(lists[row, p])
            box = boxes[e]
            tn, tf = tb._slab(box[0:3], box[3:6], (ox, oy, oz), (ix, iy, iz), tmn, tmx)
            entered = bool(tn <= tf)
            if closest:
                total += entered and bool(tn <= t_final[col])
                continue
            total += entered
            tri9, _, _ = rows_of(torch.tensor([[e]]))  # each (1, 128, 1)
            _, hit = tb._mt([c[0, :, 0] for c in tri9], (ox, oy, oz), (dx, dy, dz), tmn, tmx,
                            tb.BIG)
            if bool(hit.any()):
                break
    return total


@pytest.mark.parametrize("closest", [True, False])
def test_least_walk_work_equals_a_brute_loop(gallery, closest):
    """K2/K3's per-ray floor (``walk_work``'s least visits) on 100 rays
    equals the count of a loop over rays and list entries."""
    _, jscene, _, _, tacc = gallery
    _, tr = both_rays(random_ray_arrays(jscene, 100, seed=31))
    packed, _ = tb._sorted_table(tr, tacc, True)
    counts, lists, tn = tb.lists_from_keys(tb.cull_plain(packed, tacc.chunk_aabb, tacc.aabb))
    t_final, _ = tb.closest_plain(counts, packed, lists, tn, tacc.tri)
    rows, boxes = tb.flat_rows(tacc.tri), tb.block_boxes(tacc.tri, tacc.aabb)
    least, warp = tb.walk_work(counts, packed, lists, tn, rows, boxes, closest=closest)
    assert least == brute_least_visits(boxes, rows, packed, counts, lists, t_final, tb.TILE,
                                       closest)
    assert 0 < least and 0 < warp <= int(counts.sum()) * tb.TILE // 32


@pytest.mark.parametrize("closest", [True, False])
def test_walk_work_is_at_most_the_tile_walk(case, closest):
    """The per-ray floor and the per-warp visits never exceed the tests of
    the tile walk (``walk_tests``).  K2's floor does not depend on the tile
    width; K3's does, since its first blocking block follows list order."""
    _, jscene, _, _, tacc = case
    _, tr = both_rays(random_ray_arrays(jscene, 1000, seed=32))
    packed, _ = tb._sorted_table(tr, tacc, True)
    found = []
    for tile, group in ((tb.TILE, tb.GROUP), (64, 3)):
        counts, lists, tn = tb.lists_from_keys(
            tb.cull_plain(packed, tacc.chunk_aabb, tacc.aabb, tile))
        tests, _ = tb.walk_tests(counts, packed, lists, tn if closest else None,
                                 tb.flat_rows(tacc.tri), tile, group, closest)
        least, warp = tb.walk_work(counts, packed, lists, tn, tb.flat_rows(tacc.tri),
                                   tb.block_boxes(tacc.tri, tacc.aabb), tile, group, closest)
        assert 0 < least * tb.BLOCK <= warp * 32 * tb.BLOCK <= tests
        found.append(least)
    assert found[0] == found[1] or not closest


def test_cull_tests_equal_a_brute_loop(soup):
    """K1's count of slab tests on unsorted rays with two all-dead tiles
    (and dead rays in the others) equals a loop over tiles, chunks, groups
    of 32 blocks and rays: a dead tile tests nothing; a live one tests
    every real chunk box with all its rays; in an entered chunk, the union
    box of every group that holds a real block; and each ray entering a
    group's union tests the group's real blocks."""
    _, jscene, _, _, tacc = soup
    _, tr = both_rays(random_ray_arrays(jscene, 1000, seed=41))
    packed = tb._pack_table(tb._ray_table(tr))  # 1024 columns, 8 tiles, the last padded
    tile = tb.TILE
    for dead in (1, 4):
        packed[7, dead * tile:(dead + 1) * tile] = -tb.BIG
    chunk, aabb = tacc.chunk_aabb, tacc.aabb
    boxes = aabb.numpy()
    assert chunk.shape[0] > 1
    total = skipped_groups = 0
    for t in range(packed.shape[1] // tile):
        rays = tb._ray_rows(packed[:, t * tile:(t + 1) * tile])
        ox, oy, oz, _, _, _, ix, iy, iz, tmn, tmx = rays
        if bool((tmx < tmn).all()):
            assert t in (1, 4)
            continue
        for c in range(chunk.shape[0]):
            box = chunk[c]
            if bool(torch.isnan(box[0])):
                continue
            total += tile
            tn, tf = tb._slab(box[0:3], box[3:6], (ox, oy, oz), (ix, iy, iz), tmn, tmx)
            if not bool((tn <= tf).any()):
                continue
            for g in range(4 * c, 4 * c + 4):
                group = boxes[32 * g:32 * (g + 1)]
                real = ~np.isnan(group[:, 0])
                if not real.any():
                    continue
                total += tile
                union = torch.from_numpy(np.concatenate([group[real, 0:3].min(0),
                                                         group[real, 3:6].max(0)]))
                un, uf = tb._slab(union[0:3], union[3:6], (ox, oy, oz), (ix, iy, iz), tmn, tmx)
                inside = int((un <= uf).sum())
                skipped_groups += inside < tile
                total += inside * int(real.sum())
    assert total > 0 and skipped_groups > 0
    assert tb.cull_tests(packed, chunk, aabb, tile) == total
