"""The dense small-scene path of the port's blocked intersector
(``mcrt_tpu_torch/accel/blocked.py``, the plain versions of kernels K4/K5)
against the JAX package.

Scenes of at most 8 blocks take the dense path in both packages; the JAX
package's dense Pallas kernels run in interpret mode on the CPU.  Hit and
blocked flags must be equal and hit distances agree at the ``T_TOL`` of
``test_torch_blocked.py`` (rtol 1e-5 / atol 1e-6), against the Pallas
path and the brute-force oracle.
"""
import numpy as np
import pytest
import torch

from mcrt_tpu.accel import pallas_blocked as jpb
from mcrt_tpu.scene import builders as jb
from mcrt_tpu_torch.accel import blocked as tb
from mcrt_tpu_torch.accel import kernels
from tests.test_torch_blocked import _check_hits, both_rays, port_scene, random_ray_arrays

# one torch thread per test process (see test_torch_blocked.py)
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["cornell_box", "textured_hall"])
def small(request):
    """(name, jax scene, jax accel, port scene, port accel) of a scene of at
    most DENSE_BLOCKS blocks."""
    jscene = getattr(jb, request.param)()[0]
    tscene = port_scene(jscene)
    return (request.param, jscene, jpb.build_blocked(jscene.geometry), tscene,
            tb.build_blocked(tscene.geometry))


def test_small_scenes_take_the_dense_path(small, monkeypatch):
    """Both queries of a <= 8-block scene skip the cull and the visit lists,
    as the JAX package's ``_query_closest`` / ``_query_any`` do, and count
    no kernel launch on the CPU."""
    _, jscene, jacc, tscene, tacc = small
    assert tacc.num_blocks == jacc.num_blocks <= tb.DENSE_BLOCKS == jpb.DENSE_BLOCKS

    def refuse(*a):
        raise AssertionError("a dense-path scene reached the visit lists")

    monkeypatch.setattr(tb, "_visit_lists", refuse)
    kernels.reset_launch_counts()
    _, tr = both_rays(random_ray_arrays(jscene, 300, seed=2))
    hit = tb.intersect_blocked(tscene.geometry, tacc, tr)
    tb.occluded_blocked(tscene.geometry, tacc, tr)
    assert not any(kernels.launch_counts().values())
    assert int(hit.valid.sum()) > 50


@pytest.mark.parametrize("n", [1, 300, 2000])
def test_dense_queries_match_pallas_and_brute(small, n):
    _, jscene, jacc, tscene, tacc = small
    th, to = _check_hits(jscene, tscene, jacc, tacc, n, seed=300 + n)
    if n == 2000:
        assert int(th.valid.sum()) > 100 and int(to.sum()) > 100


def test_dense_plain_equals_the_visit_list_walk(small):
    """K4/K5's plain versions and the visit-list walk (K1-K3's) find the
    same distances and flags on the same packed rays."""
    _, jscene, _, _, tacc = small
    _, tr = both_rays(random_ray_arrays(jscene, 1000, seed=9))
    packed, _ = tb._sorted_table(tr, tacc, True)
    t_d, s_d = tb.dense_closest_plain(packed, tacc.tri)
    counts, lists, tn = tb.lists_from_keys(tb.cull_plain(packed, tacc.chunk_aabb, tacc.aabb))
    t_w, s_w = tb.closest_plain(counts, packed, lists, tn, tacc.tri)
    np.testing.assert_array_equal(s_d.numpy() >= 0, s_w.numpy() >= 0)
    np.testing.assert_array_equal(t_d.numpy(), t_w.numpy())
    np.testing.assert_array_equal(tb.dense_any_plain(packed, tacc.tri).numpy(),
                                  tb.occluded_plain(counts, packed, lists, tacc.tri).numpy())
    assert int((s_d >= 0).sum()) > 100


def test_dense_work_counts(small):
    """``dense_tests``: K4 tests every kept slot (``dense_kept``) for every
    live ray; K5 stops a ray at its first blocking kept slot (checked kept
    slot by kept slot here)."""
    _, jscene, _, _, tacc = small
    _, tr = both_rays(random_ray_arrays(jscene, 500, seed=4))
    packed, _ = tb._sorted_table(tr, tacc, False)
    kept = tb.dense_kept(tacc.tri).nonzero().flatten().tolist()
    nk = len(kept)
    assert 0 < nk < tacc.tri.shape[1]
    live = packed[7] > packed[6]
    assert tb.dense_tests(packed, tacc.tri, True) == int(live.sum()) * nk
    ox, oy, oz, dx, dy, dz, _, _, _, tmn, tmx = tb._ray_rows(packed)
    first = torch.full_like(tmn, float(nk))
    for i in reversed(range(nk)):
        _, hit = tb._mt([tacc.tri[c, kept[i]] for c in range(9)], (ox, oy, oz), (dx, dy, dz),
                        tmn, tmx, tb.BIG)
        first = torch.where(hit, float(i + 1), first)
    expected = int(torch.where(live, first, 0.0).sum())
    assert tb.dense_tests(packed, tacc.tri, False) == expected < int(live.sum()) * nk


@pytest.fixture(scope="module",
                params=[("cornell_box", 36), ("textured_hall", 44), ("glass_gallery", 687)])
def table(request):
    """(jax scene, the port's accel, the JAX table, the port's table, its
    slot_prim, the number of slots K4/K5 keep) of a dense table:
    ``cornell_box``'s and ``textured_hall``'s one block, and the first 1,024
    slots (8 blocks, the largest dense table) of ``glass_gallery``'s 47
    blocks."""
    name, n_kept = request.param
    jscene = getattr(jb, name)()[0]
    jacc = jpb.build_blocked(jscene.geometry)
    tacc = tb.build_blocked(port_scene(jscene).geometry)
    n = min(tacc.tri.shape[1], tb.DENSE_BLOCKS * tb.BLOCK)
    return (jscene, tacc, np.asarray(jacc.tri)[:, :n], tacc.tri[:, :n].contiguous(),
            tacc.slot_prim[:n], n_kept)


def test_dropped_slots_are_padding(table):
    """Every slot K4/K5 drop (e1 = e2 = 0) is a padding slot of the
    table, a column equal to the JAX package's."""
    _, _, jtri, tri, slot_prim, n_kept = table
    kept = tb.dense_kept(tri)
    dropped = (~kept).nonzero().flatten()
    assert int(kept.sum()) == n_kept and dropped.numel() > 0
    assert bool((slot_prim[dropped] == -1).all())
    assert bool((tri[3:9, dropped] == 0.0).all())
    np.testing.assert_array_equal(tri[:, dropped].numpy(), jtri[:, dropped.numpy()])


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "any"])
def test_plain_versions_agree_without_dropped_slots(table, closest):
    """K4/K5's plain versions on the table with the dropped slots removed
    (the slots K4/K5 stage), their slot indices mapped back, equal the
    plain versions on the full table bit for bit."""
    jscene, tacc, _, tri, _, _ = table
    _, tr = both_rays(random_ray_arrays(jscene, 1500, seed=21))
    packed, _ = tb._sorted_table(tr, tacc, True)
    kept = tb.dense_kept(tri).nonzero().flatten()
    small = tri[:, kept].contiguous()
    if not closest:
        b_full = tb.dense_any_plain(packed, tri)
        assert torch.equal(tb.dense_any_plain(packed, small), b_full)
        assert int(b_full.sum()) > 100
        return
    t_full, s_full = tb.dense_closest_plain(packed, tri)
    t_kept, s_kept = tb.dense_closest_plain(packed, small)
    mapped = torch.where(s_kept >= 0, kept.to(torch.int32)[s_kept.clamp_min(0).long()], -1)
    assert torch.equal(t_kept, t_full)
    assert torch.equal(mapped, s_full)
    assert int((s_full >= 0).sum()) > 100


def test_dense_wrappers_take_cuda_tensors_only(small):
    _, jscene, _, _, tacc = small
    _, tr = both_rays(random_ray_arrays(jscene, 100, seed=1))
    packed, _ = tb._sorted_table(tr, tacc, False)
    kernels.reset_launch_counts()
    for dev in ("cpu", "meta"):
        for fn in (kernels.dense_closest, kernels.dense_any):
            with pytest.raises(ValueError, match="CUDA"):
                fn(packed.to(dev), tacc.tri.to(dev))
    assert not any(kernels.launch_counts().values())
