"""The port's device mesh, sharded render and sharded gradient step on gloo
ranks (the CPU), against the port's unsharded calls and the JAX package's
sharded calls on its virtual CPU devices.

One module fixture spawns the ranks once per world size (1, 2 and 4), and
each rank runs every case on every mesh shape of its world size: (1, 1);
(1, 2), (2, 1); (2, 2), (1, 4).  The scenes cross over from the JAX
builders through ``interop``.  Sobol and RANDOM streams are bit-equal to
the JAX package's, keyed by the pixel and by the full wavefront's row, so
a rank's slice of trace slots traces what the same lanes of the full
render trace.

- ``render_spp_batch`` (PT and BDPT, ``cornell_box`` 32x32, 4 frames,
  depth 2): against the unsharded call within rtol 1e-5 / atol 1e-6 (the
  spp mean is summed in another order, and BDPT's t=1 splats of other
  ranks' light paths arrive through an all_reduce); against the JAX
  ``render_spp_batch`` on a (2, 2) mesh on at least 0.99 of pixels within
  rtol 1e-3 / atol 1e-4.
- ``make_train_step`` (``full_params``, 16x16, 4 frames): loss within rtol
  1e-5 and gradients within rtol 1e-4 / atol 1e-6 * max|g| of the
  unsharded step, and within ``GRAD_TOL`` of the JAX sharded step.
- ``instanced_boxes`` (the two-level intersector, replicated) sharded
  against its unsharded render.
- ``make_mesh``'s shapes and default; samples or pixels that do not divide
  over an axis raise ``ValueError``; a mesh that is not a ``DeviceMesh``
  raises ``TypeError``.

The JAX package is imported inside the helpers that use it: the ranks
import this module and need only the port.
"""
import time

import numpy as np
import pytest
import torch

from mcrt_tpu_torch import RenderConfig, interop
from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.config import IntegratorConfig, IntegratorType
from mcrt_tpu_torch.diff import estimators as E
from mcrt_tpu_torch.parallel.mesh import spawn_ranks
from mcrt_tpu_torch.parallel.render import make_train_step, render_spp_batch
from mcrt_tpu_torch.tools.grad_check import GRAD_TOL, MIN_AGREE

torch.set_num_threads(1)

MESHES = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4))
SIZE, DEPTH, FRAMES = 32, 2, (0, 1, 2, 3)
STEP_SIZE, TARGET_FRAMES = 16, (100, 101, 102, 103)
INSTANCED_SIZE = 16
INTEGRATORS = ("PATH", "BDPT")


def _cfg(integrator="PATH", size=SIZE):
    return RenderConfig(width=size, height=size,
                        integrator=IntegratorConfig(type=IntegratorType[integrator],
                                                    max_depth=DEPTH))


def jax_leaves(jscene, jcam):
    """A JAX scene and camera as numpy leaves for ``interop``."""
    import jax

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p).lstrip("."): np.asarray(v) for p, v in leaves}

    arrays = flat(jscene)
    if jscene.instances is not None:
        arrays["instances.face_lo"] = np.asarray(jscene.instances.face_lo)
        arrays["instances.face_hi"] = np.asarray(jscene.instances.face_hi)
    return arrays, flat(jcam)


def port_of(leaves):
    scene, cam = leaves
    return (interop.scene_from_numpy(scene, device="cpu"),
            interop.camera_from_numpy(cam, device="cpu"))


def _step(scene, cam, mesh):
    cfg = _cfg(size=STEP_SIZE)
    isect = build_intersector(scene, cfg)
    with torch.no_grad():
        target = render_spp_batch(scene, cam, TARGET_FRAMES, cfg, isect)
    view = E.full_params()
    loss, grads = make_train_step(cam, cfg, isect, mesh, view.get, view.set)(scene, FRAMES,
                                                                              target)
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def _raises(exc, fn):
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    return None


def rank_cases(rank, world, leaves, out_dir):
    """Every case on every mesh shape of ``world`` ranks; each rank saves
    its results to ``out_dir/rank<r>.pt``."""
    from mcrt_tpu_torch.parallel.mesh import (RAYS_AXIS, SPP_AXIS, axis_size, make_mesh,
                                              rays_share, spp_share)

    scene, cam = port_of(leaves["cornell_box"])
    iscene, icam = port_of(leaves["instanced_boxes"])
    default = make_mesh(device="cpu")
    out = {"default": (axis_size(default, SPP_AXIS), axis_size(default, RAYS_AXIS))}
    for shape in (m for m in MESHES if m[0] * m[1] == world):
        mesh = make_mesh(*shape, device="cpu")
        res = out[shape] = {
            "sizes": (axis_size(mesh, SPP_AXIS), axis_size(mesh, RAYS_AXIS)),
            "coords": (mesh.get_local_rank(SPP_AXIS), mesh.get_local_rank(RAYS_AXIS)),
            "frames": spp_share(mesh, FRAMES), "slots": rays_share(mesh, SIZE * SIZE)}
        for integ in INTEGRATORS:
            cfg = _cfg(integ)
            isect = build_intersector(scene, cfg)
            with torch.no_grad():
                res[integ] = render_spp_batch(scene, cam, FRAMES, cfg, isect, mesh).numpy()
        res["step"] = _step(scene, cam, mesh)
        icfg = _cfg(size=INSTANCED_SIZE)
        with torch.no_grad():
            res["instanced"] = render_spp_batch(iscene, icam, FRAMES, icfg,
                                                build_intersector(iscene, icfg), mesh).numpy()
        isect = build_intersector(scene, _cfg())
        res["odd_frames"] = _raises(ValueError, lambda: render_spp_batch(
            scene, cam, FRAMES[:3], _cfg(), isect, mesh)) if shape[0] > 1 else "n/a"
        res["odd_pixels"] = _raises(ValueError, lambda: render_spp_batch(
            scene, cam, FRAMES, _cfg(size=31), build_intersector(scene, _cfg(size=31)),
            mesh)) if shape[1] > 1 else "n/a"
        res["not_a_mesh"] = _raises(TypeError, lambda: render_spp_batch(
            scene, cam, FRAMES, _cfg(), isect, object()))
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def rank_fails_or_waits(rank, how):
    """Rank 1 raises (``how == "fails"``) or sleeps past the caller's
    timeout; rank 0 returns."""
    import time

    if rank == 1:
        if how == "fails":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(600)


@pytest.mark.parametrize("how,timeout,exc,match", [
    ("fails", 120, Exception, "rank 1 fails on purpose"),
    ("waits", 10, RuntimeError, "still running after"),
])
def test_spawn_ranks_raises_when_a_rank_fails_or_hangs(tmp_path, how, timeout, exc, match):
    """``spawn_ranks`` raises with the failing rank's traceback, or once
    its timeout has passed, having stopped every rank."""
    t0 = time.monotonic()
    with pytest.raises(exc, match=match):
        spawn_ranks(rank_fails_or_waits, 2, args=(how,), device="cpu",
                    init_method=f"file://{tmp_path}/store", timeout=timeout)
    assert time.monotonic() - t0 < timeout + 45


@pytest.fixture(scope="module")
def leaves():
    from mcrt_tpu.scene import builders as jb

    return {name: jax_leaves(*getattr(jb, name)()) for name in ("cornell_box",
                                                                 "instanced_boxes")}


def _spawn_all(leaves, tmp_dir):
    """{world size: [each rank's results]}."""
    results = {}
    for world in (1, 2, 4):
        d = tmp_dir / f"world{world}"
        d.mkdir()
        spawn_ranks(rank_cases, world, args=(world, leaves, str(d)), device="cpu",
                    init_method=f"file://{d}/store", timeout=300)
        results[world] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                          for r in range(world)]
    return results


@pytest.fixture(scope="module")
def both(leaves, tmp_path_factory):
    """(the ranks' results, the JAX package's on a (2, 2) mesh): the ranks
    run in their own processes while this one computes the JAX side."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn_all, leaves, tmp_path_factory.mktemp("ranks"))
        jax_side = _jax_refs()
        return ranks.result(), jax_side


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def unsharded(leaves):
    scene, cam = port_of(leaves["cornell_box"])
    iscene, icam = port_of(leaves["instanced_boxes"])
    out = {}
    with torch.no_grad():
        for integ in INTEGRATORS:
            cfg = _cfg(integ)
            out[integ] = render_spp_batch(scene, cam, FRAMES, cfg,
                                          build_intersector(scene, cfg)).numpy()
        icfg = _cfg(size=INSTANCED_SIZE)
        out["instanced"] = render_spp_batch(iscene, icam, FRAMES, icfg,
                                            build_intersector(iscene, icfg)).numpy()
    out["step"] = _step(scene, cam, None)
    return out


def _every_rank(ranks, shape):
    return [r[shape] for r in ranks[shape[0] * shape[1]]]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_make_mesh_shapes_and_shares(ranks, shape):
    world = shape[0] * shape[1]
    per_rank = _every_rank(ranks, shape)
    assert all(r["sizes"] == shape for r in per_rank)
    assert all(r["default"] == (1, world) for r in ranks[world])
    # rank r sits at (r // n_rays, r % n_rays), row-major as the JAX mesh
    assert [r["coords"] for r in per_rank] == [(i // shape[1], i % shape[1])
                                               for i in range(world)]
    frames = sorted(f for r in per_rank if r["coords"][1] == 0 for f in r["frames"])
    assert frames == list(FRAMES)
    slots = sorted({r["slots"] for r in per_rank})
    assert slots == [(j * SIZE * SIZE // shape[1], (j + 1) * SIZE * SIZE // shape[1])
                     for j in range(shape[1])]
    for r in per_rank:
        assert r["not_a_mesh"] and "DeviceMesh" in r["not_a_mesh"]
        assert r["odd_frames"] == "n/a" or "samples do not divide" in r["odd_frames"]
        assert r["odd_pixels"] == "n/a" or "rays do not divide" in r["odd_pixels"]


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_sharded_render_equals_unsharded(ranks, unsharded, shape, integrator):
    ref = unsharded[integrator]
    assert np.isfinite(ref).all() and ref.mean() > 0
    for r in _every_rank(ranks, shape):  # every rank returns the full mean
        np.testing.assert_allclose(r[integrator], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_sharded_instanced_render_equals_unsharded(ranks, unsharded, shape):
    ref = unsharded["instanced"]
    assert ref.mean() > 0
    for r in _every_rank(ranks, shape):
        np.testing.assert_allclose(r["instanced"], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_sharded_step_equals_unsharded(ranks, unsharded, shape):
    loss0, g0 = unsharded["step"]
    for r in _every_rank(ranks, shape):
        loss, g = r["step"]
        assert np.isclose(loss, loss0, rtol=1e-5, atol=0.0), (loss, loss0)
        for k, ref in g0.items():
            np.testing.assert_allclose(g[k], ref, rtol=1e-4,
                                       atol=1e-6 * float(np.abs(ref).max()), err_msg=k)
    assert any(np.abs(v).sum() > 0 for v in g0.values())


def _jax_mesh():
    import jax

    from mcrt_tpu.parallel.mesh import make_mesh as j_make_mesh

    return j_make_mesh(2, 2, devices=jax.devices()[:4])


def _jax_cfg(integrator="PATH", size=SIZE):
    import mcrt_tpu
    from mcrt_tpu.config import AccelType, IntegratorConfig as JIC, IntegratorType as JIT

    return mcrt_tpu.RenderConfig(width=size, height=size, accel=AccelType.BRUTE,
                                 integrator=JIC(type=JIT[integrator], max_depth=DEPTH))


def _jax_refs():
    """The JAX package on a (2, 2) mesh of its virtual CPU devices:
    ``render_spp_batch`` under PT and BDPT, and the sharded step against
    the port's unsharded target."""
    import jax.numpy as jnp

    from mcrt_tpu.accel import build_intersector as j_build
    from mcrt_tpu.diff import estimators as JE
    from mcrt_tpu.parallel.render import make_train_step as j_step
    from mcrt_tpu.parallel.render import render_spp_batch as j_render
    from mcrt_tpu.scene import builders as jb

    jscene, jcam = jb.cornell_box()
    out = {}
    for integ in INTEGRATORS:
        cfg = _jax_cfg(integ)
        out[integ] = np.asarray(j_render(jscene, jcam, jnp.asarray(FRAMES), cfg,
                                         j_build(jscene, cfg), _jax_mesh()))
    cfg = _jax_cfg(size=STEP_SIZE)
    scene, cam = port_of(jax_leaves(jscene, jcam))
    with torch.no_grad():
        tcfg = _cfg(size=STEP_SIZE)
        target = render_spp_batch(scene, cam, TARGET_FRAMES, tcfg,
                                  build_intersector(scene, tcfg)).numpy()
    view = JE.full_params()
    loss, grads = j_step(jcam, cfg, j_build(jscene, cfg), _jax_mesh(), view.get, view.set)(
        jscene, jnp.asarray(FRAMES), jnp.asarray(target))
    out["step"] = (float(loss), {k: np.asarray(g) for k, g in grads.items()})
    return out


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_sharded_render_matches_jax_mesh(both, integrator):
    ranks, jax_side = both
    jimg = jax_side[integrator]
    img = ranks[4][0][(2, 2)][integrator]
    share = np.isclose(img, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= MIN_AGREE, share
    assert np.isclose(img.mean(), jimg.mean(), rtol=1e-3)


def test_sharded_step_matches_jax_mesh(both):
    ranks, jax_side = both
    jloss, jgrads = jax_side["step"]
    loss, grads = ranks[4][0][(2, 2)]["step"]
    assert np.isclose(loss, jloss, rtol=1e-4), (loss, jloss)
    for k in grads:
        rtol, atol = GRAD_TOL[k]
        ref = jgrads[k]
        err = np.abs(grads[k] - ref)
        assert (err <= rtol * np.abs(ref) + atol * np.abs(ref).max()).all(), (k, err.max())
