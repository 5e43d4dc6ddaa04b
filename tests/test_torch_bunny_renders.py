"""Renders of the port's ``heavy_gallery`` and ``bunny_field_instanced``
against the JAX package's, on the stand-in mesh that
``chip_smoke.write_standin_obj`` writes: ``MIN_AGREE`` of pixels within
rtol 1e-3 / atol 1e-4.  Most of their time is the JAX renderer's compile,
so they have a file of their own, beside ``tests/test_torch_bunny_scenes.py``
which holds the scene tensors and the queries.
"""
import numpy as np

import mcrt_tpu
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.scene import builders as jb
from mcrt_tpu_torch import Renderer
from mcrt_tpu_torch.accel import blocked as tb
from mcrt_tpu_torch.accel import two_level as ttl
from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig, SamplerConfig, SamplerType
from mcrt_tpu_torch.scene import builders as tbuild
from tests.test_torch_bunny_scenes import MIN_AGREE, _agreement, standin  # noqa: F401


def _render_pair(name, path, jaccel_type, size=16, depth=3):
    """(port renderer, its image through ``AUTO``, the JAX image through
    ``jaccel_type``) of ``name`` at grid 2, 1 spp, Sobol."""
    jscene, jcam = getattr(jb, name)(grid=2, bunny_path=path)
    jimg = np.asarray(mcrt_tpu.Renderer(jscene, jcam, mcrt_tpu.RenderConfig(
        width=size, height=size, spp=1, accel=jaccel_type,
        sampler=JSamplerConfig(type=JSamplerType.SOBOL),
        integrator=JIntegratorConfig(max_depth=depth))).render())
    scene, cam = getattr(tbuild, name)(grid=2, bunny_path=path, device="cpu")
    r = Renderer(scene, cam, RenderConfig(
        width=size, height=size, spp=1, sampler=SamplerConfig(type=SamplerType.SOBOL),
        integrator=IntegratorConfig(max_depth=depth)), device="cpu")
    return r, r.render().numpy(), jimg


def test_heavy_gallery_renders_as_jax(standin):
    """``heavy_gallery`` (grid 2, the stand-in at subdiv 2: 1,284 triangles,
    the visit-list path) at 16x16, 1 spp, depth 3, Sobol: the port's
    ``AUTO`` against the JAX package's ``BRUTE`` on ``MIN_AGREE`` of
    pixels."""
    r, timg, jimg = _render_pair("heavy_gallery", standin[(2, True)], JAccelType.BRUTE)
    assert r.intersector.accel.num_blocks > tb.DENSE_BLOCKS
    share = _agreement(timg, jimg)
    print(f"heavy_gallery: agreement {share:.4f}, means {timg.mean():.5f} / {jimg.mean():.5f}")
    assert share >= MIN_AGREE and np.isfinite(timg).all() and timg.mean() > 0.0


def test_bunny_field_instanced_renders_as_jax(standin):
    """``bunny_field_instanced`` (grid 2: three instances) through each
    package's ``AUTO`` (the two-level path) on ``MIN_AGREE`` of pixels."""
    r, timg, jimg = _render_pair("bunny_field_instanced", standin[(1, False)],
                                 JAccelType.AUTO)
    assert isinstance(r.intersector.accel, ttl.TwoLevelAccel)
    share = _agreement(timg, jimg)
    print(f"bunny_field_instanced: agreement {share:.4f}, means {timg.mean():.5f} / "
          f"{jimg.mean():.5f}")
    assert share >= MIN_AGREE and np.isfinite(timg).all() and timg.mean() > 0.0
