"""The port's ``heavy_gallery`` against the JAX package's golden image
``tests/goldens/heavy_gallery.npz``, as ``tests/test_heavy_golden.py``
holds the JAX package: 128x128, 2 spp, depth 3, the blocked accel with the
SAH and the SBVH builders, mean-relative error under 0.02.  It needs the
Stanford bunny's ``bunny.obj``, which is not in the repository, and skips
where the JAX test skips.  It has a file of its own, so that its slow
cases hold up no worker that carries other tests.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tests.test_heavy_golden import BUNNY, DEPTH, GOLDEN, SIZE, SPP, needs_bunny

torch.set_num_threads(1)

MAX_REL = 0.02  # tests/test_heavy_golden.py's bound


@needs_bunny
@pytest.mark.parametrize("builder_name", ["sah", "sbvh"])
def test_heavy_gallery_golden(builder_name):
    from mcrt_tpu_torch import RenderConfig, Renderer
    from mcrt_tpu_torch.config import AccelType, BuilderType, BVHConfig, IntegratorConfig
    from mcrt_tpu_torch.scene.builders import heavy_gallery

    scene, camera = heavy_gallery(bunny_path=BUNNY, device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP, samples_per_pass=SPP,
                       accel=AccelType.BLOCKED, bvh=BVHConfig(builder=BuilderType(builder_name)),
                       integrator=IntegratorConfig(max_depth=DEPTH))
    img = Renderer(scene, camera, cfg, device="cpu").render().numpy()
    assert np.isfinite(img).all()
    assert os.path.exists(GOLDEN), "golden missing: run tools/make_goldens.py"
    ref = np.load(GOLDEN)["image"].astype(np.float32)
    rel = np.abs(img - ref).mean() / max(float(ref.mean()), 1e-6)
    assert rel < MAX_REL, f"{builder_name}: mean-relative error {rel:.4f}"
