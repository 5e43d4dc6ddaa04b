"""Kernels K1-K9 on the card against their plain PyTorch versions, and the
contract of ``chip_smoke.py`` where there is no card.

This file imports no JAX, so its card tests run on a machine with a GPU and
no JAX installed (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tests marked ``cuda`` skip themselves where ``torch.cuda.is_available()`` is
false.  Tolerances: cull keys and the dense kernels' outputs (closest-hit
t and slot, any-hit flags) are equal (those kernels use the plain
versions' formulas without fused multiply-add, and the dense kernels skip
only padding slots and dead rays, which never hit), and so are RANDOM draws on
the card and the CPU.  The list walks K2/K3 and K6/K7 prefilter
with a fused test and skip, per warp, list entries none of its rays
enters, so a ray may differ (a flag, a slot, an instance, or t beyond rtol
1e-5 on the same slot and instance) on at most 1e-4 of the live rays, and
never fewer than 2 rays are allowed; the K8 chains
are bit-equal to ``chain_plain`` (the same single roundings) and the K9
products lie within the dot-product bound ``2 * k * 2**-24 * (|a| @ |b|)``
of ``matmul_plain``.  Card gradients of rendered samples are held to CPU
gradients within ``tools/grad_check.py``'s tolerance (atomic scatter-adds
reorder the card's sums).
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcrt_tpu_torch.accel import blocked as tb
from mcrt_tpu_torch.accel import kernels
from mcrt_tpu_torch.accel import two_level as ttl
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.scene.builders import (cornell_box, glass_gallery, instanced_boxes,
                                           sphere_field, textured_hall)
from mcrt_tpu_torch.tools import grad_check
from mcrt_tpu_torch.tools import vpu_bench

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.build()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def gallery_cuda(cuda_device):
    scene, _ = glass_gallery(device=cuda_device)
    return scene, tb.build_blocked(scene.geometry)


@pytest.fixture(scope="module")
def boxes_cuda(cuda_device):
    scene, _ = instanced_boxes(3, device=cuda_device)
    return scene, ttl.build_two_level_scene(scene.geometry, scene.shapes.to_world,
                                            scene.instances)


def _rays(n, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3.0, 0.05, -3.0], [3.0, 3.0, 3.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.5, 1e30, rng.uniform(0.05, 3.0, n)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return Rays(o=t(o), d=t(d), tmin=t(np.full((n,), 1e-4, np.float32)), tmax=t(tmax),
                active=t(rng.random(n) > 0.1))


def _walk_allowed(packed) -> int:
    """Rays on which a list walk (K2/K3, K6/K7) may differ from its plain
    version."""
    return max(2, int(1e-4 * int((packed[7] > packed[6]).sum())))


def _closest_differing(kern, plain) -> int:
    """Rays whose slot or instance (K6), or t on the same slot and
    instance, differs between a closest-hit walk and its plain version."""
    (t_k, s_k, *i_k), (t_p, s_p, *i_p) = kern, plain
    bad = s_k != s_p
    for a, b in zip(i_k, i_p):
        bad = bad | ((s_k >= 0) & (a != b))
    same = (s_k >= 0) & ~bad
    return int((bad | (same & ~torch.isclose(t_k, t_p, rtol=1e-5, atol=0.0))).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("tile, group", [(128, 4), (256, 1), (64, 3), (128, 8)])
def test_kernels_match_plain_versions(gallery_cuda, tile, group):
    """K1 equal to its plain version, K2/K3 within the stated tolerance;
    group 8 stages two 37 KB buffers, past the 48 KB that needs no
    opt-in."""
    scene, acc = gallery_cuda
    rays = _rays(5000, seed=tile + group, device=acc.tri.device)
    packed, _ = tb._sorted_table(rays, acc, True)  # 5120 columns
    before = kernels.launch_counts()
    keys = kernels.cull(packed, acc.chunk_aabb, acc.aabb, tile)
    assert torch.equal(keys, tb.cull_plain(packed, acc.chunk_aabb, acc.aabb, tile))
    counts, lists, tn = tb.lists_from_keys(keys)
    allowed = _walk_allowed(packed)
    t_k, s_k = kernels.closest(counts, packed, lists, tn, acc.tri, acc.aabb, tile, group)
    plain = tb.closest_plain(counts, packed, lists, tn, acc.tri, tile, group)
    assert _closest_differing((t_k, s_k), plain) <= allowed
    hit = s_k >= 0
    b_k = kernels.occluded(counts, packed, lists, acc.tri, acc.aabb, tile, group)
    b_p = tb.occluded_plain(counts, packed, lists, acc.tri, tile, group)
    assert int((b_k != b_p).sum()) <= allowed
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in ("K1", "K2", "K3")} == {"K1": 1, "K2": 1, "K3": 1}
    assert int(hit.sum()) > 100 and int(b_k.sum()) > 100


@pytest.mark.cuda
def test_a_warp_entering_no_listed_box_misses(gallery_cuda):
    """One tile whose last warp of rays leaves the scene from beyond its
    upper corner: the tile's list comes from the other rays, that warp
    skips every listed block and returns misses and unblocked flags."""
    _, acc = gallery_cuda
    rays = _rays(tb.TILE, seed=9, device=acc.tri.device)
    away = torch.arange(tb.TILE, device=acc.tri.device) >= tb.TILE - 32
    o = torch.where(away[:, None], acc.bounds[1] + 1.0, rays.o)
    d = torch.where(away[:, None], rays.d.abs(), rays.d)
    rays = Rays.make(o.contiguous(), d.contiguous(), tmax=rays.tmax, active=rays.active | away)
    packed = tb._pack_table(tb._ray_table(rays))  # unsorted: the warp stays one warp
    counts, lists, tn = tb.lists_from_keys(kernels.cull(packed, acc.chunk_aabb, acc.aabb,
                                                        tb.TILE))
    assert int(counts[0]) > 0
    for group in (tb.GROUP, 8):
        t, slot = kernels.closest(counts, packed, lists, tn, acc.tri, acc.aabb, tb.TILE, group)
        blocked = kernels.occluded(counts, packed, lists, acc.tri, acc.aabb, tb.TILE, group)
        assert (slot[away] == -1).all() and (t[away] == tb.BIG).all()
        assert (blocked[away] == 0.0).all()
        assert int((slot[~away] >= 0).sum()) > 10
        assert _closest_differing((t, slot), tb.closest_plain(
            counts, packed, lists, tn, acc.tri, tb.TILE, group)) <= _walk_allowed(packed)


@pytest.mark.cuda
def test_nan_poisoned_boxes_are_never_entered_on_the_card(gallery_cuda):
    """CUDA's fminf/fmaxf drop NaN; the kernels must not, or every ray
    would enter an empty block or chunk."""
    _, acc = gallery_cuda
    rays = _rays(2048, seed=3, device=acc.tri.device)
    packed = tb._pack_table(tb._ray_table(rays))
    aabb = acc.aabb.clone()
    aabb[5, 0:6] = float("nan")
    keys = kernels.cull(packed, acc.chunk_aabb, aabb, tb.TILE)
    assert (keys[:, 5] == tb.BIG).all()
    assert (keys[:, acc.num_blocks:] == tb.BIG).all()  # padding blocks
    nan_chunks = torch.full_like(acc.chunk_aabb, float("nan"))
    assert (kernels.cull(packed, nan_chunks, acc.aabb, tb.TILE) == tb.BIG).all()


@pytest.fixture(scope="module")
def field_cuda(cuda_device):
    """``sphere_field`` at subdiv 4: 752 blocks, 6 cull chunks."""
    scene, _ = sphere_field(subdiv=4, device=cuda_device)
    return scene, tb.build_blocked(scene.geometry)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [32, 128, 1024])
def test_cull_keys_equal_plain_version_over_several_chunks(field_cuda, tile):
    """K1 on a 6-chunk table at the narrowest and widest tiles: keys equal
    to ``cull_plain``.  Coherence-sorted rays with segments of at most 1
    (dead rays last); then tile 1 is made all dead between live tiles,
    and tile 2 holds one live ray with a NaN origin, which enters
    nothing, as in the plain version.  Some tile enters some chunks and
    skips others."""
    _, acc = field_cuda
    packed, _ = tb._sorted_table(_rays(4096, seed=tile, device=acc.tri.device), acc, True)
    packed[7].clamp_(max=1.0)
    packed[7, tile:3 * tile] = -tb.BIG
    packed[0, 2 * tile] = float("nan")
    packed[7, 2 * tile] = 1e30
    before = kernels.launch_counts()["K1"]
    keys = kernels.cull(packed, acc.chunk_aabb, acc.aabb, tile)
    plain = tb.cull_plain(packed, acc.chunk_aabb, acc.aabb, tile)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["K1"] == before + 1
    assert torch.equal(keys, plain)
    assert (keys[1:3] == tb.BIG).all()
    n_chunks = acc.chunk_aabb.shape[0]
    entered = (keys < 0.5 * tb.BIG).reshape(keys.shape[0], n_chunks, 128).any(dim=2)
    assert n_chunks == 6 and bool(entered[0].any())
    assert bool((entered.any(dim=1) & ~entered.all(dim=1)).any())


@pytest.mark.cuda
def test_random_draw_on_the_card_equals_the_cpu_draw(cuda_device):
    """One RANDOM ``next_3d`` draw (threefry in int64 on the pixels'
    device) is bit-equal on the card and on the CPU."""
    from mcrt_tpu_torch.config import SamplerConfig
    from mcrt_tpu_torch.sampling import rng

    pixels = torch.arange(70_001, dtype=torch.int32)
    draws = [rng.next_3d(rng.make_stream(SamplerConfig(seed=5), 70_000, pixels.to(d))
                         .advance(65_540))[0].cpu() for d in (cuda_device, "cpu")]
    assert torch.equal(draws[0].view(torch.int32), draws[1].view(torch.int32))
    assert draws[0].shape == (70_001, 3) and 0.0 <= float(draws[0].min())


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(gallery_cuda):
    _, acc = gallery_cuda
    packed = tb._pack_table(tb._ray_table(_rays(256, seed=1, device=acc.tri.device)))
    with pytest.raises(TypeError):
        kernels.cull(packed.double(), acc.chunk_aabb, acc.aabb, 128)
    with pytest.raises(ValueError):
        kernels.cull(packed, acc.chunk_aabb, acc.aabb, 100)
    with pytest.raises(ValueError):
        kernels.cull(packed.t().contiguous().t(), acc.chunk_aabb, acc.aabb, 128)
    with pytest.raises(ValueError):
        kernels.cull(packed, acc.chunk_aabb.cpu(), acc.aabb, 128)
    counts, lists, tn = tb.lists_from_keys(kernels.cull(packed, acc.chunk_aabb, acc.aabb, 128))
    with pytest.raises(ValueError, match="aabb"):
        kernels.closest(counts, packed, lists, tn, acc.tri, acc.aabb[:-1], 128, 4)
    shifted = torch.empty(acc.aabb.numel() + 1, device=acc.aabb.device)[1:].view(acc.aabb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.occluded(counts, packed, lists, acc.tri, shifted, 128, 4)
    with pytest.raises(ValueError, match="group"):
        kernels.occluded(counts, packed, lists, acc.tri, acc.aabb, 128, 9)


@pytest.mark.cuda
def _check_closest(kern, plain):
    (t_k, s_k), (t_p, s_p) = kern, plain
    assert torch.equal(s_k, s_p)
    assert torch.equal(t_k, t_p)
    return int((s_k >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 8])
def test_dense_kernels_match_plain_versions(gallery_cuda, blocks):
    """K4/K5 on ``cornell_box``'s 1-block table and on the largest (8-block)
    dense table, the first 1,024 slots of ``glass_gallery``'s (its 48 KB of
    staged records need the shared-memory opt-in), with a ragged end: 4,992
    padded rays are not a multiple of the rays a CTA serves."""
    _, acc = gallery_cuda
    if blocks == 1:
        acc = tb.build_blocked(cornell_box(device=acc.tri.device)[0].geometry)
    tri = acc.tri[:, :blocks * 128].contiguous()
    packed = tb._pack_table(tb._ray_table(_rays(4900, seed=blocks, device=acc.tri.device)))
    assert packed.shape[1] == 4992
    before = kernels.launch_counts()
    hits = _check_closest(kernels.dense_closest(packed, tri), tb.dense_closest_plain(packed, tri))
    b_k = kernels.dense_any(packed, tri)
    assert torch.equal(b_k, tb.dense_any_plain(packed, tri))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in ("K4", "K5")} == {"K4": 1, "K5": 1}
    assert hits > 20 and int(b_k.sum()) > 20


def _dense_case(acc, case):
    """(packed rays, table) of a K4/K5 edge case: the table is
    ``glass_gallery``'s first two blocks with slot 177 replaced by a
    floor-wide triangle at y = 0.5, under which ``_rays`` start in the box
    [-3, 3] x [0.05, 3] x [-3, 3], so that many rays hit."""
    dev = acc.tri.device
    n = {"dead CTAs": 9000, "dead between": 5000, "ragged": 4900, "one CTA": 100}.get(case, 3000)
    rays = _rays(n, seed=len(case), device=dev)
    if case == "dead CTAs":  # dead spans that fill whole CTAs, between live ones
        idx = torch.arange(n, device=dev)
        rays.active = rays.active & ~(((idx >= 1024) & (idx < 4096)) | (idx >= 7168))
    elif case == "dead between":  # every other ray dead
        rays.active = rays.active & (torch.arange(n, device=dev) % 2 == 0)
    packed = tb._pack_table(tb._ray_table(rays))
    tri = acc.tri[:, :256].clone()
    tri[:9, 177] = torch.tensor([-3.0, 0.5, -3.0, 6.0, 0.0, 0.0, 0.0, 0.0, 6.0], device=dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    drop = torch.zeros(256, dtype=torch.bool)
    if case == "padding inside":  # padding columns scattered through both blocks
        drop = torch.rand(256, generator=g) < 0.4
    elif case in ("one real slot", "no real slot"):
        drop = torch.ones(256, dtype=torch.bool)
    drop[177] = case == "no real slot"
    drop = drop.to(dev)
    tri[3:9, drop] = 0.0
    tri[0:3, drop] = torch.randn((3, int(drop.sum())), generator=g).to(dev)
    return packed, tri.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dead CTAs", "dead between", "ragged", "one CTA",
                                  "padding inside", "one real slot", "no real slot"])
def test_dense_kernels_on_edge_cases(gallery_cuda, case):
    """K4/K5 equal to their plain versions bit for bit (t, slot, blocked)
    where the redesign's shortcuts act: CTAs whose rays are all dead
    (they exit before staging) and dead rays between live ones; a ragged
    end (4,992 padded rays) and a wavefront smaller than one CTA (128);
    padding columns inside the blocks (each CTA drops them and keeps the
    rest in slot order); a table with a single real slot, and none."""
    _, acc = gallery_cuda
    packed, tri = _dense_case(acc, case)
    t_k, s_k = kernels.dense_closest(packed, tri)
    t_p, s_p = tb.dense_closest_plain(packed, tri)
    b_k, b_p = kernels.dense_any(packed, tri), tb.dense_any_plain(packed, tri)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p) and torch.equal(t_k, t_p) and torch.equal(b_k, b_p)
    live = packed[7] > packed[6]
    assert bool((s_k[~live] == -1).all()) and bool((b_k[~live] == 0.0).all())
    assert bool((t_k[~live] == tb.BIG).all())
    if case == "no real slot":
        assert not bool((s_k >= 0).any())
    elif case == "one real slot":
        assert bool(((s_k == 177) | (s_k == -1)).all()) and int((s_k == 177).sum()) > 10
    else:
        assert int((s_k >= 0).sum()) > 0.05 * int(live.sum())
        assert int(b_k.sum()) > 0.05 * int(live.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("tile, group", [(128, 4), (256, 1), (64, 3), (128, 8)])
def test_two_level_kernels_match_plain_versions(boxes_cuda, tile, group):
    """K1 over the pair boxes equal to its plain version, K6/K7 within the
    stated tolerance; group 8 stages a raw and a world buffer of 37 KB
    each, past the 48 KB that needs no opt-in."""
    _, acc = boxes_cuda
    rays = _rays(5000, seed=tile + group, device=acc.blas.tri.device)
    packed, _ = tb._sorted_table(rays, acc, True)
    keys = kernels.cull(packed, acc.pair_chunk, acc.pair_aabb, tile)
    assert torch.equal(keys, tb.cull_plain(packed, acc.pair_chunk, acc.pair_aabb, tile))
    counts, lists, tn = tb.lists_from_keys(keys)
    args = (acc.blas.tri, acc.pair_code, acc.tw_rows)
    allowed = _walk_allowed(packed)
    before = kernels.launch_counts()
    out = kernels.closest2(counts, packed, lists, tn, *args, acc.pair_aabb, tile, group)
    plain = ttl.closest2_plain(counts, packed, lists, tn, *args, tile, group)
    assert _closest_differing(out, plain) <= allowed
    b_k = kernels.occluded2(counts, packed, lists, *args, acc.pair_aabb, tile, group)
    b_p = ttl.occluded2_plain(counts, packed, lists, *args, tile, group)
    assert int((b_k != b_p).sum()) <= allowed
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in ("K6", "K7")} == {"K6": 1, "K7": 1}
    assert int((out[1] >= 0).sum()) > 100 and int(b_k.sum()) > 100


@pytest.mark.cuda
def test_a_warp_entering_no_listed_pair_box_misses(boxes_cuda):
    """K6/K7 on one tile whose last warp of rays leaves the scene from
    beyond its upper corner: the tile's pair list comes from the other
    rays (``instanced_boxes``' rotated instances give loose pair boxes),
    that warp skips every listed pair and returns misses and unblocked
    flags."""
    _, acc = boxes_cuda
    dev = acc.blas.tri.device
    rays = _rays(tb.TILE, seed=9, device=dev)
    away = torch.arange(tb.TILE, device=dev) >= tb.TILE - 32
    o = torch.where(away[:, None], acc.bounds[1] + 1.0, rays.o)
    d = torch.where(away[:, None], rays.d.abs(), rays.d)
    rays = Rays.make(o.contiguous(), d.contiguous(), tmax=rays.tmax, active=rays.active | away)
    packed = tb._pack_table(tb._ray_table(rays))  # unsorted: the warp stays one warp
    counts, lists, tn = tb.lists_from_keys(kernels.cull(packed, acc.pair_chunk, acc.pair_aabb,
                                                        tb.TILE))
    assert int(counts[0]) > 0
    args = (acc.blas.tri, acc.pair_code, acc.tw_rows)
    for group in (tb.GROUP, 8):
        t, slot, inst = kernels.closest2(counts, packed, lists, tn, *args, acc.pair_aabb,
                                         tb.TILE, group)
        blocked = kernels.occluded2(counts, packed, lists, *args, acc.pair_aabb, tb.TILE, group)
        assert (slot[away] == -1).all() and (inst[away] == -1).all()
        assert (t[away] == tb.BIG).all() and (blocked[away] == 0.0).all()
        assert int((slot[~away] >= 0).sum()) > 10
        assert _closest_differing((t, slot, inst), ttl.closest2_plain(
            counts, packed, lists, tn, *args, tb.TILE, group)) <= _walk_allowed(packed)


@pytest.mark.cuda
def test_nan_poisoned_pair_box_is_never_entered_on_the_card(boxes_cuda):
    """A NaN-poisoned (instance, block) pair box gets key BIG from every
    tile, so no pair list holds it."""
    _, acc = boxes_cuda
    p = 3
    lo, hi = acc.pair_aabb[p, 0:3], acc.pair_aabb[p, 3:6]
    n = 512
    g = torch.Generator(device=lo.device).manual_seed(0)
    target = lo + (hi - lo) * torch.rand((n, 3), generator=g, device=lo.device)
    o = (acc.bounds[1] + 1.0).expand(n, 3).contiguous()
    d = target - o
    packed = tb._pack_table(tb._ray_table(Rays.make(o, d / d.norm(dim=1, keepdim=True))))
    assert (kernels.cull(packed, acc.pair_chunk, acc.pair_aabb, tb.TILE)[:, p] < tb.BIG).all()
    poisoned = acc.pair_aabb.clone()
    poisoned[p, 0:6] = float("nan")
    keys = kernels.cull(packed, acc.pair_chunk, poisoned, tb.TILE)
    assert (keys[:, p] == tb.BIG).all()
    counts, lists, _ = tb.lists_from_keys(keys)
    for row, c in zip(lists.cpu(), counts.cpu()):
        assert p not in row[:int(c)].tolist()


@pytest.mark.cuda
def test_new_wrappers_refuse_bad_inputs(gallery_cuda, boxes_cuda):
    _, acc = gallery_cuda
    packed = tb._pack_table(tb._ray_table(_rays(256, seed=1, device=acc.tri.device)))
    with pytest.raises(ValueError, match="1024"):
        kernels.dense_closest(packed, acc.tri[:, :9 * 128].contiguous())
    with pytest.raises(TypeError):
        kernels.dense_any(packed, acc.tri[:, :128].double())
    _, two = boxes_cuda
    counts, lists, tn = ttl.pair_lists(packed, two)
    tri, code, tw, box = two.blas.tri, two.pair_code, two.tw_rows, two.pair_aabb
    with pytest.raises(TypeError):
        kernels.closest2(counts, packed, lists, tn, tri, code.long(), tw, box, tb.TILE,
                         tb.GROUP)
    with pytest.raises(ValueError, match="tw_rows"):
        kernels.occluded2(counts, packed, lists, tri, code, tw[:-1], box, tb.TILE, tb.GROUP)
    with pytest.raises(ValueError, match="pair_aabb"):
        kernels.closest2(counts, packed, lists, tn, tri, code, tw, box[:-1], tb.TILE,
                         tb.GROUP)
    with pytest.raises(TypeError):
        kernels.occluded2(counts, packed, lists, tri, code, tw, box.double(), tb.TILE,
                          tb.GROUP)
    shifted = torch.empty(box.numel() + 1, device=box.device)[1:].view(box.shape)
    shifted.copy_(box)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.occluded2(counts, packed, lists, tri, code, tw, shifted, tb.TILE, tb.GROUP)
    wide = tb._pack_table(tb._ray_table(_rays(512, seed=2, device=acc.tri.device)))
    wc, wl, wt = tb.lists_from_keys(kernels.cull(wide, two.pair_chunk, box, 512))
    with pytest.raises(ValueError, match="tile 512"):
        kernels.closest2(wc, wide, wl, wt, tri, code, tw, box, 512, tb.GROUP)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vpu_chain_equals_plain_version(cuda_device, dtype):
    x = vpu_bench.chain_input(cuda_device)
    before = kernels.launch_counts()["K8"]
    out = vpu_bench.run_chain(x, dtype, iters=3)
    plain = vpu_bench.chain_plain(x, dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["K8"] == before + 1
    view = torch.int32 if dtype == torch.float32 else torch.int16
    assert out.dtype == dtype and torch.equal(out.view(view), plain.view(view))
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,many", [(torch.bfloat16, 39), (torch.float32, 75)])
def test_vpu_chain_does_not_depend_on_iters(cuda_device, dtype, many):
    """K8 splits a chain's passes over warps and runs a warp's S at once
    (S = 4 for bfloat16, 8 for float32) and the rest one by one.  At 1 and
    3 passes no warp of an H100's full grid (132 SMs x 64 warps) gets S; at
    ``many`` (9 * S + 3) passes every warp gets more than 2 * S, most not a
    multiple of S: each gives chain_plain's bits."""
    x = vpu_bench.chain_input(cuda_device)
    view = torch.int32 if dtype == torch.float32 else torch.int16
    plain = vpu_bench.chain_plain(x, dtype).view(view)
    for n in (1, 3, many):
        out = vpu_bench.run_chain(x, dtype, iters=n)
        assert torch.equal(out.view(view), plain), f"{n} passes"


@pytest.mark.cuda
@pytest.mark.parametrize("k", vpu_bench.KS + vpu_bench.GENERIC_KS)
def test_vpu_matmul_within_dot_bound_of_plain_version(cuda_device, k):
    a, b = vpu_bench.matmul_inputs(cuda_device, k)
    before = kernels.launch_counts()["K9"]
    out = vpu_bench.run_matmul(a, b, iters=3)
    plain = vpu_bench.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["K9"] == before + 1
    tol = 2 * k * 2.0**-24 * (a.double().abs() @ b.double().abs())
    assert bool(((out.double() - plain.double()).abs() <= tol).all())


@pytest.mark.cuda
def test_vpu_wrappers_refuse_bad_inputs(cuda_device):
    x = vpu_bench.chain_input(cuda_device)
    with pytest.raises(ValueError):
        kernels.vpu_chain(x.cpu(), 2)
    with pytest.raises(ValueError):
        kernels.vpu_chain(x[:128].contiguous(), 2)
    with pytest.raises(TypeError):
        kernels.vpu_chain(x.double(), 2)
    with pytest.raises(ValueError):
        kernels.vpu_chain(x, 0)
    odd = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    with pytest.raises(ValueError):  # contiguous, but not on a 4-byte boundary
        kernels.vpu_chain(odd.view(x.shape), 2)
    a, b = vpu_bench.matmul_inputs(cuda_device, 8)
    with pytest.raises(ValueError):
        kernels.vpu_matmul(a.cpu(), b.cpu(), 2)
    with pytest.raises(ValueError):
        kernels.vpu_matmul(a[:, :5].contiguous(), b, 2)
    with pytest.raises(ValueError):
        kernels.vpu_matmul(a[:500].contiguous(), b, 2)
    with pytest.raises(ValueError):
        kernels.vpu_matmul(a, b[:, :512].contiguous(), 2)
    with pytest.raises(ValueError):
        kernels.vpu_matmul(a, b.t().contiguous().t(), 2)


@pytest.mark.cuda
def test_cuda_render_matches_cpu_render(cuda_device):
    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig, SamplerConfig, SamplerType

    cfg = RenderConfig(width=24, height=24, sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=3))
    imgs = [Renderer(*cornell_box(device=d), cfg, device=d).render(2).cpu()
            for d in (cuda_device, "cpu")]
    close = torch.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4).all(dim=-1)
    assert close.float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("builder, view, size, spp, float_texels", [
    (cornell_box, "material_params", 16, 16, False),
    (cornell_box, "light_params", 16, 16, False),
    (textured_hall, "texture_params", 12, 4, True)], ids=["material", "light", "texels"])
def test_card_gradients_match_cpu_gradients(cuda_device, builder, view, size, spp,
                                            float_texels):
    """Gradients of the image sum at ``tests/test_torch_diff.py``'s sizes
    (depth 2), the card's against the CPU's, over the (sample, pixel) pairs
    whose forward radiance agrees (at least 99%), within
    ``grad_check.GRAD_TOL``."""
    share, grads = grad_check.device_parity(builder, view, size, spp, 2, cuda_device,
                                            float_texels)
    assert share >= grad_check.MIN_AGREE
    for k, (err, scale, ok) in grad_check.compare(grads).items():
        assert ok, (k, err, scale)
    assert any(float(a.abs().sum()) > 0 for a, _ in grads.values())


def _soup(n_tris, seed, device):
    """A soup of small random triangles (``tests/test_lbvh.py``'s recipe):
    its SBVH decomposition references some triangles from two blocks."""
    from mcrt_tpu_torch.scene.scene import UberMaterial, build_scene

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    offs = rng.normal(scale=0.08, size=(n_tris, 3, 3)).astype(np.float32)
    pos = (centers[:, None, :] + offs).reshape(-1, 3)
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (len(pos), 1))
    return build_scene(pos, nrm, np.zeros((len(pos), 2), np.float32),
                       np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3),
                       np.zeros((n_tris,), np.int32), np.asarray([0]),
                       [UberMaterial(diffuse=(0.5, 0.5, 0.5))], device=device)


def _moved(scene, shape):
    """``scene`` with shape ``shape`` moved and turned (``SceneAnimator``)."""
    from mcrt_tpu_torch.scene.dynamic import SceneAnimator, rotation_y, translation

    return SceneAnimator.create(scene).set_transform(
        shape, translation((0.3, 0.1, -0.2)) @ rotation_y(0.7))


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["sbvh", "refit"])
def test_sbvh_and_refitted_walks_match_plain_versions(cuda_device, table):
    """K1 equal to its plain version and K2/K3 within the walks' tolerance
    on tables the builds never made before refit and SBVH: SBVH blocks of a
    2,000-triangle soup (duplicated references, clipped boxes) and the SAH
    blocks of ``glass_gallery`` refitted after a shape moved."""
    from mcrt_tpu_torch.config import BuilderType, BVHConfig

    if table == "sbvh":
        scene = _soup(2000, 11, cuda_device)
        acc = tb.build_blocked(scene.geometry, BVHConfig(builder=BuilderType.SBVH))
        slots = acc.slot_prim[acc.slot_prim >= 0]
        assert acc.builder == "sbvh" and slots.unique().numel() < slots.numel()
    else:
        scene, _ = glass_gallery(device=cuda_device)
        moved = _moved(scene, 1)
        acc = tb.refit_blocked(tb.build_blocked(scene.geometry), moved.geometry)
    rays = _rays(8000, seed=5, device=cuda_device)
    rays = rays.replace(o=rays.o * 0.5)  # inside the soup's box too
    packed, _ = tb._sorted_table(rays, acc, True)
    keys = kernels.cull(packed, acc.chunk_aabb, acc.aabb, tb.TILE)
    assert torch.equal(keys, tb.cull_plain(packed, acc.chunk_aabb, acc.aabb, tb.TILE))
    counts, lists, tn = tb.lists_from_keys(keys)
    allowed = _walk_allowed(packed)
    out = kernels.closest(counts, packed, lists, tn, acc.tri, acc.aabb, tb.TILE, tb.GROUP)
    plain = tb.closest_plain(counts, packed, lists, tn, acc.tri, tb.TILE, tb.GROUP)
    assert _closest_differing(out, plain) <= allowed
    b_k = kernels.occluded(counts, packed, lists, acc.tri, acc.aabb, tb.TILE, tb.GROUP)
    b_p = tb.occluded_plain(counts, packed, lists, acc.tri, tb.TILE, tb.GROUP)
    assert int((b_k != b_p).sum()) <= allowed
    assert int((out[1] >= 0).sum()) > 100 and int(b_k.sum()) > 100


def _nan_equal(a, b) -> bool:
    return torch.equal(torch.nan_to_num(a.cpu(), nan=7.0), torch.nan_to_num(b.cpu(), nan=7.0))


@pytest.mark.cuda
def test_card_refit_equals_cpu_refit(cuda_device):
    """``refit_blocked`` and ``refit_two_level_scene`` on the card equal the
    same refits of the same inputs on the CPU, bit for bit: gathers,
    subtractions, min/max and products without fused multiply-add."""
    from mcrt_tpu_torch.scene.dynamic import rotation_y, set_shape_transform, translation

    scene, _ = glass_gallery(device=cuda_device)
    moved = _moved(scene, 1)
    acc = tb.build_blocked(scene.geometry)
    card = tb.refit_blocked(acc, moved.geometry)
    cpu = tb.refit_blocked(acc.to("cpu"), moved.geometry.to("cpu"))
    for k in ("tri", "aabb", "slot_prim", "bounds", "chunk_aabb"):
        assert _nan_equal(getattr(card, k), getattr(cpu, k)), k
    scene, _ = instanced_boxes(3, device=cuda_device)
    acc = ttl.build_two_level_scene(scene.geometry, scene.shapes.to_world, scene.instances)
    moved = set_shape_transform(scene, int(scene.instances.shape[2].item()),
                                translation((0.5, 0.2, -0.3)) @ rotation_y(1.1))
    card = ttl.refit_two_level_scene(acc, moved)
    cpu = ttl.refit_two_level_scene(acc.to("cpu"), moved.to("cpu"))
    for k in ("world_to_object", "tw_rows", "pair_aabb", "pair_chunk", "bounds"):
        assert _nan_equal(getattr(card, k), getattr(cpu, k)), k


@pytest.mark.cuda
def test_animated_frame_makes_no_host_sync(cuda_device):
    """A frame of ``make_animated_frame`` (transform from a host array,
    refit, render) under torch's CUDA sync debug mode "error": no
    synchronizing call; then ``Scene.to`` and a ``Renderer`` on the
    default device keep the card's tensors, as ``update_scene`` needs."""
    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig
    from mcrt_tpu_torch.film.accumulate import Accumulator
    from mcrt_tpu_torch.scene.dynamic import SceneAnimator, make_animated_frame, rotation_y

    scene, camera = glass_gallery(device=cuda_device)
    cfg = RenderConfig(width=64, height=64, integrator=IntegratorConfig(max_depth=3))
    anim = SceneAnimator.create(scene)
    frame_fn = make_animated_frame(anim, camera, cfg)
    accum = Accumulator.zeros(cfg.width, cfg.height, cuda_device)
    t = anim.identity_transforms()
    _, accum = frame_fn(t, accum, 0)  # warm-up
    t[1] = rotation_y(0.5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moved, accum = frame_fn(t, accum, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert accum.frame == 2 and bool(torch.isfinite(accum.image).all())
    again = moved.to(torch.device("cuda"))
    assert again.geometry.indices is scene.geometry.indices
    assert again.geometry.positions is moved.geometry.positions
    assert Renderer(moved, camera, cfg).scene.geometry.positions is moved.geometry.positions


def _bdpt_cfg(size, depth, **kw):
    from mcrt_tpu_torch.config import (IntegratorConfig, IntegratorType, RenderConfig,
                                       SamplerConfig, SamplerType)

    return RenderConfig(width=size, height=size, sampler=SamplerConfig(type=SamplerType.SOBOL),
                        integrator=IntegratorConfig(type=IntegratorType.BDPT, max_depth=depth),
                        **kw)


@pytest.mark.cuda
def test_bdpt_card_render_matches_cpu_render(cuda_device):
    """A 1-spp BDPT frame of ``glass_gallery`` (K1-K3) on the card against
    the same frame on the CPU: at least 99% of pixels within rtol 1e-3 /
    atol 1e-4 (the t=1 splats are float atomics on the card)."""
    from mcrt_tpu_torch import Renderer

    cfg = _bdpt_cfg(32, 3)
    imgs = [Renderer(*glass_gallery(device=d), cfg, device=d).render(1).cpu()
            for d in (cuda_device, "cpu")]
    close = torch.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4).all(dim=-1)
    assert close.float().mean().item() >= 0.99
    assert imgs[0].mean() > 0.0


@pytest.mark.cuda
def test_bdpt_frame_makes_no_host_sync(cuda_device):
    """A BDPT frame of ``glass_gallery`` under torch's CUDA sync debug mode
    "error", after one warm-up frame: no synchronizing call."""
    from mcrt_tpu_torch import Renderer

    r = Renderer(*glass_gallery(device=cuda_device), _bdpt_cfg(64, 3), device=cuda_device)
    r.step(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.step(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert r.accum.frame == 2 and bool(torch.isfinite(r.display_image()).all())


class _Captured(Exception):
    pass


@pytest.mark.cuda
def test_bdpt_occlusion_chunk_through_k1_k3(cuda_device):
    """One full occlusion chunk (``OCC_CHUNK_RAYS`` = 2^21 shadow rays) of a
    512x512, depth-8 BDPT sample of ``sphere_field``, taken from the
    renderer, through K1 and K3: the cull keys equal ``cull_plain``'s and
    the blocked flags differ from ``occluded_plain``'s on at most the walks'
    allowance (1e-4 of the live rays, never fewer than 2)."""
    from mcrt_tpu_torch.accel import Intersector, build_intersector
    from mcrt_tpu_torch.integrators import bdpt
    from mcrt_tpu_torch.renderer import render_sample

    scene, camera = sphere_field(device=cuda_device)
    cfg = _bdpt_cfg(512, 8)
    base = build_intersector(scene, cfg)
    chunk = []

    def capture(s, rays):
        if rays.n == bdpt.OCC_CHUNK_RAYS:
            chunk.append(rays)
            raise _Captured
        return base.occluded(s, rays)

    with torch.no_grad(), pytest.raises(_Captured):
        render_sample(scene, camera, 0, cfg, Intersector(base.intersect, capture, base.accel))
    rays, acc = chunk[0], base.accel
    assert rays.n == 1 << 21 and int(rays.active.sum()) > 100_000
    packed, _ = tb._sorted_table(rays, acc, True)
    keys = kernels.cull(packed, acc.chunk_aabb, acc.aabb, tb.TILE)
    assert torch.equal(keys, tb.cull_plain(packed, acc.chunk_aabb, acc.aabb, tb.TILE))
    counts, lists, _ = tb.lists_from_keys(keys)
    b_k = kernels.occluded(counts, packed, lists, acc.tri, acc.aabb, tb.TILE, tb.GROUP)
    b_p = tb.occluded_plain(counts, packed, lists, acc.tri, tb.TILE, tb.GROUP)
    assert int((b_k != b_p).sum()) <= _walk_allowed(packed)
    assert int(b_k.sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["material_params", "light_params"])
def test_bdpt_card_gradients_match_cpu_gradients(cuda_device, view):
    """BDPT gradients of the image sum (``cornell_box`` 16x16, 4 spp,
    depth 2), the card's against the CPU's, over the (sample, pixel) pairs
    whose forward radiance agrees, within ``grad_check.GRAD_TOL``."""
    share, grads = grad_check.device_parity(cornell_box, view, 16, 4, 2, cuda_device,
                                            integrator="BDPT")
    assert share >= grad_check.MIN_AGREE
    for k, (err, scale, ok) in grad_check.compare(grads).items():
        assert ok, (k, err, scale)
    assert any(float(a.abs().sum()) > 0 for a, _ in grads.values())


@pytest.mark.cuda
def test_viewer_on_the_card(cuda_device):
    """The viewer on the card: a one-ray pick through the kernels' padding
    hits what the CPU's pick hits, a material edit keeps the accel, and the
    published stats carry the card's memory."""
    from mcrt_tpu_torch import Renderer, RenderConfig
    from mcrt_tpu_torch.config import IntegratorConfig
    from mcrt_tpu_torch.viewer import ProgressiveViewer

    cfg = RenderConfig(width=32, height=32, integrator=IntegratorConfig(max_depth=2))
    views = {d: ProgressiveViewer(Renderer(*cornell_box(device=d), cfg, device=d), port=0)
             for d in (cuda_device, "cpu")}
    try:
        picks = {d: v.pick(0.5, 0.4) for d, v in views.items()}
        assert picks[cuda_device]["hit"] and picks[cuda_device]["shape"] == picks["cpu"]["shape"]
        v = views[cuda_device]
        isect = v.renderer.intersector
        v.enqueue_material(0, diffuse=(0.9, 0.1, 0.1))
        v.serve(max_steps=2)
        assert v.renderer.intersector is isect and v.status()["spp"] == 2
        st = v.stats()
        assert 0 < st["device_bytes_in_use"] < st["device_bytes_limit"]
    finally:
        for v in views.values():
            v.stop()


@pytest.mark.cuda
def test_checkpoint_resumes_a_card_render_bit_for_bit(cuda_device, tmp_path):
    from mcrt_tpu_torch import Renderer, RenderConfig
    from mcrt_tpu_torch.config import IntegratorConfig
    from mcrt_tpu_torch.utils import checkpoint

    cfg = RenderConfig(width=64, height=64, integrator=IntegratorConfig(max_depth=3))
    scene, camera = textured_hall(device=cuda_device)
    whole = Renderer(scene, camera, cfg, device=cuda_device)
    whole.step(4)
    first = Renderer(scene, camera, cfg, device=cuda_device)
    first.step(2)
    path = str(tmp_path / "acc.npz")
    checkpoint.save_accumulator(path, first.accum)
    resumed = Renderer(scene, camera, cfg, device=cuda_device)
    resumed.accum, _ = checkpoint.load_accumulator(path)
    assert resumed.accum.weighted.device.type == "cuda"
    resumed.step(2)
    assert torch.equal(resumed.accum.weighted, whole.accum.weighted)


@pytest.mark.parametrize("isolated", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, isolated):
    """With no CUDA device, and in a directory holding only the script,
    ``chip_smoke.py`` exits nonzero and prints no result line."""
    if torch.cuda.is_available() and not isolated:
        pytest.skip("a CUDA device is present: the script would run in full")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if isolated:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_issue_rates_needs_a_card():
    """The issue-rate probe refuses to run, with code 2, where there is no
    CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe would run in full")
    from mcrt_tpu_torch.tools import issue_rates

    assert issue_rates.main([]) == 2


def test_profile_frame_needs_a_card():
    """The profiling script refuses to run, with a nonzero code, where
    there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run in full")
    from mcrt_tpu_torch.tools import profile_frame

    assert profile_frame.main([]) == 2
