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
    """``dense_tests``: K4 tests every slot for every live ray; K5 stops a
    ray at its first blocking slot (checked slot by slot here)."""
    _, jscene, _, _, tacc = small
    _, tr = both_rays(random_ray_arrays(jscene, 500, seed=4))
    packed, _ = tb._sorted_table(tr, tacc, False)
    nt = tacc.tri.shape[1]
    live = packed[7] > packed[6]
    assert tb.dense_tests(packed, tacc.tri, True) == int(live.sum()) * nt
    ox, oy, oz, dx, dy, dz, _, _, _, tmn, tmx = tb._ray_rows(packed)
    first = torch.full_like(tmn, float(nt))
    for j in reversed(range(nt)):
        _, hit = tb._mt([tacc.tri[c, j] for c in range(9)], (ox, oy, oz), (dx, dy, dz),
                        tmn, tmx, tb.BIG)
        first = torch.where(hit, float(j + 1), first)
    expected = int(torch.where(live, first, 0.0).sum())
    assert tb.dense_tests(packed, tacc.tri, False) == expected < int(live.sum()) * nt


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
