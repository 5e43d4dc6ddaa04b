"""Inverse rendering with the port's ``InverseRenderer`` (``torch.optim.Adam``
with optax's defaults), against the criteria of ``tests/test_diff.py``'s
two recoveries and against the JAX package's ``InverseRenderer``.

- A point light's position, from a target rendered at the true position:
  the last loss below 5% of the first, the position within 0.1.
- The red wall's albedo of ``cornell_box``: the last loss below 10% of the
  first, the (clipped) albedo within 0.15.
- Both packages' optimizers, started from the same parameters
  (``interop.params_from_numpy``) on the same target, give the same loss
  curve over the first 5 steps, within rtol 2e-4.  The curve, not the
  parameters coordinate by coordinate: Adam's first steps move a
  coordinate by about ``lr * sign(g)``, so a gradient of about 0 may step
  either way in the two packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu.accel import build_intersector as j_build_intersector
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import RenderConfig as JRenderConfig
from mcrt_tpu.diff import estimators as JE
from mcrt_tpu.parallel.render import render_spp_batch as j_render_spp_batch
from mcrt_tpu.scene import builders as jb
from mcrt_tpu_torch import interop
from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig
from mcrt_tpu_torch.diff import estimators as E
from mcrt_tpu_torch.parallel.render import render_spp_batch
from mcrt_tpu_torch.scene import builders as tbuild
from tests.test_diff import _point_light_scene as j_point_light_scene
from tests.test_torch_blocked import port_scene
from tests.test_torch_diff import point_light_scene
from tests.test_torch_render import _camera

torch.set_num_threads(1)

CURVE_RTOL = 2e-4
CURVE_STEPS = 5


def _cfg(size=16, spp=8, depth=2):
    return RenderConfig(width=size, height=size, spp=spp,
                        integrator=IntegratorConfig(max_depth=depth))


def test_inverse_rendering_recovers_light_position():
    true_pos = (0.3, 1.5, 0.2)
    scene, camera = point_light_scene(true_pos)
    cfg = _cfg()
    with torch.no_grad():
        target = render_spp_batch(scene, camera, range(8), cfg, build_intersector(scene, cfg))
    wrong, _ = point_light_scene((-0.2, 1.2, -0.2))
    inv = E.InverseRenderer(wrong, camera, cfg, E.light_geometry_params(), learning_rate=0.05)
    recovered, params, losses = inv.run(target, steps=80, spp_per_step=8, seed=0,
                                        advance_frames=False)
    print(f"light position: loss {losses[0]:.4g} -> {losses[-1]:.4g}, "
          f"{recovered.lights.position[0].tolist()}")
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    assert params["position"].is_leaf and params["position"].requires_grad
    np.testing.assert_allclose(recovered.lights.position[0].numpy(), np.asarray(true_pos),
                               atol=0.1)


def _wrong_albedo(scene):
    diffuse = scene.materials.diffuse.clone()
    diffuse[1] = torch.tensor([0.3, 0.3, 0.3])
    return scene.replace(materials=scene.materials.replace(diffuse=diffuse))


def test_inverse_rendering_recovers_albedo():
    scene, camera = tbuild.cornell_box(device="cpu")
    cfg = _cfg()
    with torch.no_grad():
        target = render_spp_batch(scene, camera, range(8), cfg, build_intersector(scene, cfg))
    inv = E.InverseRenderer(_wrong_albedo(scene), camera, cfg, E.material_params(),
                            learning_rate=0.1)
    recovered, _, losses = inv.run(target, steps=60, spp_per_step=8, seed=0,
                                   advance_frames=False)
    got = recovered.materials.diffuse[1].numpy()
    print(f"albedo: loss {losses[0]:.4g} -> {losses[-1]:.4g}, {got.tolist()}")
    assert losses[-1] < losses[0] * 0.1, losses[:3] + losses[-3:]
    np.testing.assert_allclose(got, scene.materials.diffuse[1].numpy(), atol=0.15)


def _jax_wrong_albedo(jscene):
    return jscene.replace(materials=jscene.materials.replace(
        diffuse=jscene.materials.diffuse.at[1].set(jnp.asarray([0.3, 0.3, 0.3]))))


@pytest.mark.parametrize("case", ["albedo", "light-position"])
def test_loss_curve_matches_jax_inverse_renderer(case):
    """Five Adam steps of both packages from the same parameters on the
    same target (the JAX package's render, handed to both)."""
    if case == "albedo":
        jtrue, jcam = jb.cornell_box()
        jstart, view, lr = _jax_wrong_albedo(jtrue), "material_params", 0.1
    else:
        jtrue, jcam = j_point_light_scene((0.3, 1.5, 0.2))
        jstart, _ = j_point_light_scene((-0.2, 1.2, -0.2))
        view, lr = "light_geometry_params", 0.05
    jcfg = JRenderConfig(width=16, height=16, spp=8, accel=JAccelType.BRUTE,
                         integrator=JIntegratorConfig(max_depth=2))
    target = np.asarray(j_render_spp_batch(jtrue, jcam, jnp.arange(8, dtype=jnp.int32), jcfg,
                                           j_build_intersector(jtrue, jcfg)))
    jinv = JE.InverseRenderer(jstart, jcam, jcfg, getattr(JE, view)(), learning_rate=lr)
    _, _, jlosses = jinv.run(jnp.asarray(target), steps=CURVE_STEPS, spp_per_step=8, seed=0,
                             advance_frames=False)

    tstart, tcam = port_scene(jstart), _camera(jcam)
    tview = getattr(E, view)()
    start = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in getattr(JE, view)().get(jstart).items()}, device="cpu")
    tstart = tview.set(tstart, {k: v.detach() for k, v in start.items()})
    tinv = E.InverseRenderer(tstart, tcam, _cfg(), tview, learning_rate=lr)
    _, _, tlosses = tinv.run(torch.from_numpy(target.copy()), steps=CURVE_STEPS,
                             spp_per_step=8, seed=0, advance_frames=False)
    print(f"{case}: port {tlosses}\n   jax {jlosses}")
    assert jlosses[-1] < jlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=CURVE_RTOL)
