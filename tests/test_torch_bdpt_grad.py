"""BDPT gradients on torch autograd: the port against ``jax.grad`` of the JAX
package's BDPT, against finite differences, through ``make_train_step``
with and without a mesh, and the frame without a graph unchanged.

- **Against the JAX reference.** Numpy-seeded jittered camera rays and
  Sobol streams go through ``mcrt_tpu.integrators.bdpt.trace`` under
  ``jax.grad`` and through the port's ``bdpt.trace`` under
  ``torch.autograd.grad``, with ``full_params`` (the fields of both
  ``material_params`` and ``light_params``): ``cornell_box`` at 8x8,
  depths 2 and 3, and ``instanced_boxes`` at depth 2 (the JAX side on
  ``AUTO``, its two-level kernels in interpret mode; on ``cornell_box`` its
  brute-force oracle; the port on its queries' plain versions).  As in
  ``tests/test_torch_diff.py``, the image sum is weighted by the pixels
  whose forward radiance agrees (rtol 1e-3 / atol 1e-4; at least
  ``MIN_AGREE`` of them) and each field is held to
  ``|port - jax| <= RTOL * |jax| + ATOL * max|jax|`` with ``TOL``, that
  file's tolerance (``grad_check.GRAD_TOL``).
- **Finite differences.** The port's central differences of its own BDPT
  image sum on fixed sample streams, for the diffuse albedo channel and
  the light intensity channel with the largest gradient.
- **The step.** ``make_train_step`` under BDPT equals ``render_loss_fn``
  plus autograd; ``InverseRenderer`` under BDPT lowers its loss.
- **The sharded step** on 2 gloo ranks, a (1, 2) rays mesh (each rank's
  t=1 splats summed over the ranks by a differentiable ``all_reduce``)
  and a (2, 1) spp mesh, against the unsharded step at
  ``tests/test_torch_parallel.py``'s tolerance.
- **The frame without a graph is unchanged**: under ``torch.no_grad()`` a
  ``Renderer`` frame equals ``tests/goldens/torch_bdpt_frames.npz`` bit for
  bit (rendered by the in-place vertex storage that the per-vertex records
  replaced), and equals the same frame traced with parameters that
  require grad.
"""
import functools
import os

import numpy as np
import pytest
import torch

from mcrt_tpu_torch import Renderer, interop
from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.config import (IntegratorConfig, IntegratorType, RenderConfig,
                                   SamplerConfig, SamplerType)
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.diff import estimators as E
from mcrt_tpu_torch.integrators import bdpt
from mcrt_tpu_torch.parallel.mesh import spawn_ranks
from mcrt_tpu_torch.parallel.render import make_train_step, render_spp_batch
from mcrt_tpu_torch.renderer import render_sample
from mcrt_tpu_torch.sampling import rng
from mcrt_tpu_torch.scene import builders as tbuild
from mcrt_tpu_torch.tools import grad_check
from mcrt_tpu_torch.tools.grad_check import MIN_AGREE

torch.set_num_threads(1)

W = 8
N = W * W
# per field: (RTOL, ATOL as a share of the field's largest JAX gradient),
# tests/test_torch_diff.py's tolerance
TOL = grad_check.GRAD_TOL
FIELDS = ("diffuse", "roughness", "intensity")
JAX_CASES = {  # builder name, depth, the JAX side's queries (AUTO or the oracle)
    "cornell-d2": ("cornell_box", 2, "BRUTE"),
    "cornell-d3": ("cornell_box", 3, "BRUTE"),
    "instanced-d2": ("instanced_boxes", 2, "AUTO"),
}
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "torch_bdpt_frames.npz")
GOLDEN_SCENES = {"cornell_box": 3, "glass_gallery": 3, "instanced_boxes": 2}  # depths


def _bdpt_cfg(size, depth, spp=1):
    return RenderConfig(width=size, height=size, spp=spp,
                        integrator=IntegratorConfig(type=IntegratorType.BDPT, max_depth=depth))


# --------------------------------------------------------------------------
# Against jax.grad of the JAX package's BDPT
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def grads_both(case):
    """(share of agreeing pixels, {field: (port grad, JAX grad)}) of the
    BDPT image sum over the agreeing pixels, both packages on the same
    tables, rays and Sobol streams.  The JAX package is imported here: the
    sharded step's ranks import this module and need only the port."""
    import jax
    import jax.numpy as jnp

    from mcrt_tpu.accel import build_intersector as j_build_intersector
    from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
    from mcrt_tpu.camera.pinhole import pixel_uv as j_pixel_uv
    from mcrt_tpu.config import AccelType, SamplerType as JSamplerType
    from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
    from mcrt_tpu.config import RenderConfig as JRenderConfig
    from mcrt_tpu.config import SamplerConfig as JSamplerConfig
    from mcrt_tpu.core.types import Rays as JRays
    from mcrt_tpu.diff import estimators as JE
    from mcrt_tpu.integrators import bdpt as jbdpt
    from mcrt_tpu.sampling import rng as jrng
    from mcrt_tpu.scene import builders as jb
    from tests.test_torch_blocked import port_scene
    from tests.test_torch_render import _camera

    name, depth, accel = JAX_CASES[case]
    jscene, jcam = getattr(jb, name)()
    jit = np.random.default_rng(0).uniform(-0.5, 0.5, (N, 2)).astype(np.float32)
    o, d = (np.array(a) for a in jcam.generate_rays(j_pixel_uv(W, W,
                                                               jitter=jnp.asarray(jit))))
    if accel == "BRUTE":
        jint = lambda s, r: intersect_brute(s.geometry, r)  # noqa: E731
        jocc = lambda s, r: occluded_brute(s.geometry, r)  # noqa: E731
    else:
        jisect = j_build_intersector(jscene, JRenderConfig(width=W, height=W,
                                                           accel=AccelType[accel]))
        jint, jocc = jisect.intersect, jisect.occluded
    jstream = jrng.make_stream(JSamplerConfig(type=JSamplerType.SOBOL), jnp.asarray(0),
                               jnp.arange(N))
    jview = JE.full_params()
    jparams = jview.get(jscene)

    def jimage(p):
        return jbdpt.trace(jview.set(jscene, p), jcam, JRays.make(jnp.asarray(o), jnp.asarray(d)),
                           jstream, JIntegratorConfig(max_depth=depth), jint, jocc)

    # one compile: the image comes out as the gradient's auxiliary output
    jgrad = jax.jit(jax.grad(lambda p, w: (jnp.sum((img := jimage(p)) * w), img),
                             has_aux=True))
    jg, jimg = jgrad(jparams, jnp.ones((N, 1), jnp.float32))

    tscene, tcam = port_scene(jscene), _camera(jcam)
    isect = build_intersector(tscene, RenderConfig(width=W, height=W))
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                   device="cpu")
    tstream = rng.make_stream(SamplerConfig(type=SamplerType.SOBOL), 0, torch.arange(N))
    timg = bdpt.trace(E.full_params().set(tscene, tp), tcam,
                      Rays.make(torch.from_numpy(o), torch.from_numpy(d)), tstream,
                      IntegratorConfig(max_depth=depth), isect.intersect, isect.occluded)
    agree = np.isclose(timg.detach().numpy(), np.asarray(jimg), rtol=1e-3, atol=1e-4).all(-1)
    w = agree.astype(np.float32)[:, None]
    if not agree.all():
        jg, _ = jgrad(jparams, jnp.asarray(w))
    tg = torch.autograd.grad((timg * torch.from_numpy(w)).sum(), list(tp.values()),
                             allow_unused=True)
    out = {k: (np.zeros(v.shape, np.float32) if g is None else g.numpy(), np.asarray(jg[k]))
           for (k, v), g in zip(tp.items(), tg)}
    return float(agree.mean()), out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_bdpt_grads_match_jax(case, field):
    share, grads = grads_both(case)
    t, j = grads[field]
    rtol, atol = TOL[field]
    scale = float(np.abs(j).max())
    err = np.abs(t - j)
    print(f"{case} {field}: max |port - jax| {err.max():.3g}, max |jax| {scale:.4g}, "
          f"agreeing pixels {share:.4f}")
    assert share >= MIN_AGREE, share
    assert np.isfinite(t).all() and np.isfinite(j).all()
    assert (err <= rtol * np.abs(j) + atol * scale).all(), (err.max(), scale)
    if field != "roughness":  # cornell_box and instanced_boxes have no glossy lobe
        assert scale > 0 and (np.abs(t) > 0).any()


# --------------------------------------------------------------------------
# Finite differences, the step and the optimizer
# --------------------------------------------------------------------------


def _cornell(size=16, depth=2):
    scene, camera = tbuild.cornell_box(device="cpu")
    cfg = _bdpt_cfg(size, depth)
    return scene, camera, cfg, build_intersector(scene, cfg)


@pytest.mark.parametrize("field, eps, rel", [("diffuse", 1e-3, 0.05), ("intensity", 1e-2, 0.02)])
def test_bdpt_grad_matches_fd(field, eps, rel):
    """The element of ``field`` with the largest gradient against central
    differences of the image sum on fixed sample streams (the t=1 splats
    included): ``tests/test_torch_diff.py``'s steps and bounds."""
    scene, camera, cfg, isect = _cornell()
    view, frames = E.full_params(), range(4)

    def f(params):
        return render_spp_batch(view.set(scene, params), camera, frames, cfg, isect).sum()

    base = {k: v.detach().clone() for k, v in view.get(scene).items()}
    leaves = {k: v.clone().requires_grad_() for k, v in base.items()}
    (g,) = torch.autograd.grad(f(leaves), [leaves[field]])
    k = int(g.abs().argmax())
    vals = []
    for sign in (1.0, -1.0):
        x = base[field].double().clone()
        x.view(-1)[k] += sign * eps
        with torch.no_grad():
            vals.append(float(f({**base, field: x.float()})))
    fd = (vals[0] - vals[1]) / (2 * eps)
    ad = float(g.view(-1)[k])
    print(f"{field}[{k}]: autograd {ad:.6g}, central difference {fd:.6g}")
    assert abs(ad) > 0
    assert abs(fd - ad) <= rel * max(abs(fd), abs(ad), 1.0), (fd, ad)


def test_make_train_step_under_bdpt_equals_loss_fn_and_autograd():
    scene, camera, cfg, isect = _cornell(size=12)
    view = E.full_params()
    with torch.no_grad():
        target = render_spp_batch(scene, camera, [7, 8], cfg, isect) * 0.8
    loss, grads = make_train_step(camera, cfg, isect, None, view.get, view.set)(
        scene, [0, 1], target)
    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}
    ref = E.render_loss_fn(camera, cfg, isect, view)(params, scene, [0, 1], target)
    ref_g = torch.autograd.grad(ref, list(params.values()), allow_unused=True)
    assert torch.equal(loss, ref.detach())
    for (k, v), g in zip(params.items(), ref_g):
        assert torch.equal(grads[k], torch.zeros_like(v) if g is None else g), k
    assert float(grads["diffuse"].abs().sum()) > 0 and float(grads["intensity"].abs().sum()) > 0


def test_inverse_renderer_under_bdpt_lowers_the_loss():
    """``InverseRenderer`` with BDPT from a wrong red-wall albedo, on the
    target's own sample streams (``advance_frames=False``)."""
    scene, camera, cfg, isect = _cornell(size=8)
    with torch.no_grad():
        target = render_spp_batch(scene, camera, range(4), cfg, isect)
    diffuse = scene.materials.diffuse.clone()
    diffuse[1] = 0.3
    wrong = scene.replace(materials=scene.materials.replace(diffuse=diffuse))
    inv = E.InverseRenderer(wrong, camera, cfg, E.material_params(), learning_rate=0.1)
    fitted, _, losses = inv.run(target, steps=12, spp_per_step=4, seed=0,
                                advance_frames=False)
    print("losses", [f"{v:.4e}" for v in losses])
    assert all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]
    err_before = float((diffuse[1] - scene.materials.diffuse[1]).abs().max())
    err_after = float((fitted.materials.diffuse[1] - scene.materials.diffuse[1]).abs().max())
    assert err_after < err_before


def test_graph_bytes_counts_the_saved_graph(capsys):
    """``tools/graph_bytes.py``: a BDPT sample saves more for its backward
    than a path-traced one, and the command prints the count a lane."""
    from mcrt_tpu_torch.tools import graph_bytes

    scene, camera, cfg, _ = _cornell(size=8, depth=3)
    path_cfg = RenderConfig(width=8, height=8, integrator=IntegratorConfig(max_depth=3))
    view = E.full_params()
    bdpt_bytes = graph_bytes.saved_bytes(scene, camera, cfg, view)
    path_bytes = graph_bytes.saved_bytes(scene, camera, path_cfg, view)
    assert bdpt_bytes > 2 * path_bytes > 0
    assert graph_bytes.main(["cornell_box", "--integrator", "bdpt", "--size", "8",
                             "--depth", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    printed = int(out.split(": ")[1].split(" bytes saved for the backward")[0])
    assert printed > 2 * path_bytes and out.rstrip().endswith("GiB")


def test_splat_backward_gathers_the_film_cotangent():
    gen = torch.Generator().manual_seed(0)
    L = torch.randn(10, 3, dtype=torch.float64, generator=gen).requires_grad_()
    contrib = torch.randn(2, 6, 3, dtype=torch.float64, generator=gen).requires_grad_()
    flat = torch.tensor([[0, 3, 3, 9, 1, 3], [9, 9, 2, 0, 5, 7]])
    assert torch.autograd.gradcheck(lambda a, c: bdpt._splat(a, flat, c), (L, contrib))
    cot = torch.randn(10, 3, dtype=torch.float64, generator=gen)
    g_l, g_c = torch.autograd.grad(bdpt._splat(L, flat, contrib), (L, contrib), cot)
    assert torch.equal(g_l, cot)
    assert torch.equal(g_c, cot[flat.reshape(-1)].reshape(2, 6, 3))


# --------------------------------------------------------------------------
# The sharded step on gloo ranks
# --------------------------------------------------------------------------

STEP_MESHES = ((1, 2), (2, 1))
STEP_SIZE, STEP_FRAMES, TARGET_FRAMES = 16, (0, 1), (100, 101)


def _step(mesh):
    scene, camera, cfg, isect = _cornell(size=STEP_SIZE)
    with torch.no_grad():
        target = render_spp_batch(scene, camera, TARGET_FRAMES, cfg, isect)
    view = E.full_params()
    loss, grads = make_train_step(camera, cfg, isect, mesh, view.get, view.set)(
        scene, STEP_FRAMES, target)
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def rank_steps(rank, out_dir):
    """The BDPT step on each mesh of ``STEP_MESHES``; each rank saves its
    results to ``out_dir/rank<r>.pt``."""
    from mcrt_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    torch.save({shape: _step(make_mesh(*shape, device="cpu")) for shape in STEP_MESHES},
               f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    d = tmp_path_factory.mktemp("bdpt_ranks")
    spawn_ranks(rank_steps, 2, args=(str(d),), device="cpu", init_method=f"file://{d}/store",
                timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("shape", STEP_MESHES, ids=str)
def test_sharded_bdpt_step_equals_unsharded(sharded_steps, shape):
    loss0, g0 = _step(None)
    assert any(np.abs(v).sum() > 0 for v in g0.values())
    for r in sharded_steps:
        loss, g = r[shape]
        assert np.isclose(loss, loss0, rtol=1e-5, atol=0.0), (loss, loss0)
        for k, ref in g0.items():
            np.testing.assert_allclose(g[k], ref, rtol=1e-4,
                                       atol=1e-6 * float(np.abs(ref).max()), err_msg=k)


# --------------------------------------------------------------------------
# The frame without a graph
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GOLDEN_SCENES))
def test_frame_without_graph_unchanged(name):
    """The dense (``cornell_box``), visit-list (``glass_gallery``) and
    two-level (``instanced_boxes``) paths at 16x16, 1 spp."""
    scene, camera = getattr(tbuild, name)(device="cpu")
    cfg = _bdpt_cfg(16, GOLDEN_SCENES[name])
    with torch.no_grad():
        img = Renderer(scene, camera, cfg, device="cpu").render().numpy()
    np.testing.assert_array_equal(img, np.load(GOLDEN)[name])
    isect = build_intersector(scene, cfg)
    view = E.full_params()
    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}
    with torch.no_grad():
        plain = render_sample(scene, camera, 0, cfg, isect)[0]
    graph = render_sample(view.set(scene, params), camera, 0, cfg, isect)[0]
    assert graph.requires_grad and torch.equal(graph.detach(), plain)
