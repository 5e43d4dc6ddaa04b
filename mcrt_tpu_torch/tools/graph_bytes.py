"""Bytes autograd keeps for the backward of one gradient sample: the
distinct storages the forward hands to
``torch.autograd.graph.saved_tensors_hooks`` while it renders one sample
of the image loss (``full_params``, Sobol), in all and per lane (pixel).

    python -m mcrt_tpu_torch.tools.graph_bytes [SCENE] [--integrator bdpt]
        [--size 64] [--depth 8] [--device cpu]

A count from the tensors' sizes, the same on any device: it predicts the
saved graph's share of a gradient step's peak memory at another size (the
bytes a lane times its lanes), before the step runs there; the forward's
short-lived tensors come on top.  Like every entry point it runs on the
CUDA card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..cli import SCENES


def saved_bytes(scene, camera, cfg, view) -> int:
    """Bytes of the distinct storages (by address and size) autograd saves
    while ``render_spp_batch`` renders sample 0 of ``view.set(scene,
    params)``."""
    from ..accel import build_intersector
    from ..parallel.render import render_spp_batch

    isect = build_intersector(scene, cfg)
    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}
    storages = {}

    def keep(t):
        st = t.untyped_storage()
        storages[(st.data_ptr(), st.nbytes())] = st.nbytes()
        return t

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
        render_spp_batch(view.set(scene, params), camera, [0], cfg, isect)
    return sum(storages.values())


def main(argv=None) -> int:
    from ..config import (IntegratorConfig, IntegratorType, RenderConfig, SamplerConfig,
                          SamplerType)
    from ..core.types import default_device
    from ..diff import estimators
    from ..scene import builders

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", nargs="?", default="sphere_field", choices=SCENES)
    ap.add_argument("--integrator", default="path", choices=("path", "bdpt"))
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    cfg = RenderConfig(width=args.size, height=args.size,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(type=IntegratorType[args.integrator.upper()],
                                                   max_depth=args.depth))
    scene, camera = getattr(builders, args.scene)(device=device)
    total = saved_bytes(scene, camera, cfg, estimators.full_params())
    lanes = args.size * args.size
    print(f"{args.scene} {args.size}x{args.size}, depth {args.depth}, {args.integrator}, "
          f"full_params, on {device}: {total} bytes saved for the backward, "
          f"{total / lanes:.0f} a lane; at 512x512 {total / lanes * 512 * 512 / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
