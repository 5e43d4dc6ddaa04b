"""Kernels K1-K3 on the card against their plain PyTorch versions, and the
contract of ``chip_smoke.py`` where there is no card.

This file imports no JAX, so its card tests run on a machine with a GPU and
no JAX installed (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tests marked ``cuda`` skip themselves where ``torch.cuda.is_available()`` is
false.  Tolerances: cull keys and any-hit flags are equal (the kernels use
the plain versions' formulas without fused multiply-add); closest-hit
flags and slots are equal and distances agree to rtol 1e-5.
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
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.scene.builders import glass_gallery

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


def _rays(n, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3.0, 0.05, -3.0], [3.0, 3.0, 3.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.5, 1e30, rng.uniform(0.05, 3.0, n)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return Rays(o=t(o), d=t(d), tmin=t(np.full((n,), 1e-4, np.float32)), tmax=t(tmax),
                active=t(rng.random(n) > 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("tile, group", [(128, 4), (256, 1), (64, 3)])
def test_kernels_match_plain_versions(gallery_cuda, tile, group):
    scene, acc = gallery_cuda
    rays = _rays(5000, seed=tile + group, device=acc.tri.device)
    packed, _ = tb._sorted_table(rays, acc, True)  # 5120 columns
    before = kernels.launch_counts()
    keys = kernels.cull(packed, acc.chunk_aabb, acc.aabb, tile)
    assert torch.equal(keys, tb.cull_plain(packed, acc.chunk_aabb, acc.aabb, tile))
    counts, lists, tn = tb.lists_from_keys(keys)
    t_k, s_k = kernels.closest(counts, packed, lists, tn, acc.tri, tile, group)
    t_p, s_p = tb.closest_plain(counts, packed, lists, tn, acc.tri, tile, group)
    assert torch.equal(s_k >= 0, s_p >= 0) and torch.equal(s_k, s_p)
    hit = s_k >= 0
    torch.testing.assert_close(t_k[hit], t_p[hit], rtol=1e-5, atol=0.0)
    b_k = kernels.occluded(counts, packed, lists, acc.tri, tile, group)
    assert torch.equal(b_k, tb.occluded_plain(counts, packed, lists, acc.tri, tile, group))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {"K1": 1, "K2": 1, "K3": 1}
    assert int(hit.sum()) > 100 and int(b_k.sum()) > 100


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


@pytest.mark.cuda
def test_cuda_render_matches_cpu_render(cuda_device):
    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig, SamplerConfig, SamplerType
    from mcrt_tpu_torch.scene.builders import cornell_box

    cfg = RenderConfig(width=24, height=24, sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=3))
    imgs = [Renderer(*cornell_box(device=d), cfg, device=d).render(2).cpu()
            for d in (cuda_device, "cpu")]
    close = torch.isclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4).all(dim=-1)
    assert close.float().mean().item() >= 0.99


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


def test_profile_frame_needs_a_card():
    """The profiling script refuses to run, with a nonzero code, where
    there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run in full")
    from mcrt_tpu_torch.tools import profile_frame

    assert profile_frame.main([]) == 2
