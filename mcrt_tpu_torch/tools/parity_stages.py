"""Where a render on the card departs from the same render on the CPU.

    python -m mcrt_tpu_torch.tools.parity_stages [SCENE]

SCENE (a builder of ``scene.builders``; default ``textured_hall``) is
rendered at ``chip_smoke.py``'s parity configuration (64x64, 1 spp, Sobol,
max_depth 3) through ``Renderer``, and every render is held against the
one on the CPU (the plain versions of the kernels) at ``chip_smoke.py``'s
measure: the share of pixels whose three channels agree to rtol 1e-3 /
atol 1e-4.

1. On the card with the kernels, as ``chip_smoke.py`` renders it, and on
   the card with the dense kernels K4/K5 replaced by their plain versions
   (on the card): if both depart alike, the kernels are cleared.
2. Hybrid renders: on the CPU, with one stage at a time run on the card
   (its inputs copied there, its outputs copied back).  A stage whose
   hybrid render departs from the CPU render is a source of the gap; one
   that agrees at 1.0000 computes bit for bit or near enough alike on both
   devices.
   Each stage also prints how many of its output elements differ in
   their bits between the devices, called on the same inputs, and, for
   each bounce, the lanes whose discrete decisions (the primitive hit,
   whether the path goes on, whether a shadow ray is traced) differ from
   the CPU render's.
3. The texture LOD of the first bounce (the only one with ray
   differentials): ``compute_lod``'s inputs recorded in the CPU render,
   computed again on both devices; prints the lanes whose LOD differs and
   those whose mip level (its floor) differs.
4. The float32 operations the shading uses (rsqrt, sqrt, log2, exp, sin,
   a 3-term sum, ...), each on the same seeded inputs on both devices:
   the share of elements whose bits differ, and by how many ulp.

A diagnostic: nothing of the main path imports it, and it changes no
module for longer than one of its renders.  Exits 2 without a card.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

SIZE, DEPTH = 64, 3


def _move(v, device, memo):
    """``v`` with every tensor in it (through tuples, lists, dicts and
    dataclasses) on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if id(v) in memo and memo[id(v)][0] is v:  # the scene, copied once
        return memo[id(v)][1]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        out = dataclasses.replace(v, **{f.name: _move(getattr(v, f.name), device, memo)
                                        for f in dataclasses.fields(v) if f.init})
        memo[id(v)] = (v, out)  # keeps v alive, so its id is not reused
        return out
    if isinstance(v, (tuple, list)):
        return type(v)(_move(x, device, memo) for x in v)
    if isinstance(v, dict):
        return {k: _move(x, device, memo) for k, x in v.items()}
    return v


def _tensors(v):
    """The tensors in ``v`` (through tuples, lists, dicts and dataclasses)."""
    if isinstance(v, torch.Tensor):
        return [v]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return [t for f in dataclasses.fields(v) for t in _tensors(getattr(v, f.name))]
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _tensors(x)]
    if isinstance(v, dict):
        return [t for x in v.values() for t in _tensors(x)]
    return []


class Stage:
    """One stage's functions run on the card inside a CPU render.  A call
    made from the CPU render computes the function on both devices, tallies
    the output elements whose bits differ, and hands the card's result on;
    a call made from inside another of the stage's functions, already on
    the card, runs there as it is."""

    def __init__(self, card, memo):
        self.card, self.memo = card, memo
        self.inside = False
        self.elements = self.differing = 0
        self.max_diff = 0.0

    def wrap(self, fn):
        def run(*args, **kw):
            if self.inside:
                return fn(*args, **kw)
            self.inside = True
            try:
                out = fn(*_move(args, self.card, self.memo), **_move(kw, self.card, self.memo))
            finally:
                self.inside = False
            out = _move(out, "cpu", {})
            for a, b in zip(_tensors(out), _tensors(fn(*args, **kw))):
                self._tally(a, b)
            return out
        return run

    def _tally(self, a, b):
        self.elements += a.numel()
        if a.dtype.is_floating_point:
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            if (~same).any():
                self.max_diff = max(self.max_diff, (a - b)[~same].abs().max().item())
        else:
            same = a == b
        self.differing += int((~same).sum())


def _stages():
    """name -> [(owner, attribute), ...] of the functions that stage runs."""
    from ..accel import blocked
    from ..bsdf import uber
    from ..camera.pinhole import PinholeCamera
    from ..integrators import path
    from ..lights import lights
    from ..sampling import rng
    from ..scene import textures
    from .. import renderer

    return {
        "hits (K4/K5 kernels)": [(blocked, "_dense_query")],
        "camera rays": [(PinholeCamera, "generate_rays"),
                        (PinholeCamera, "generate_ray_differentials")],
        "sampler": [(rng, "next_1d"), (rng, "next_2d"), (rng, "next_3d")],
        "interaction": [(path, "compute_interaction")],
        "texture LOD (compute_lod)": [(textures, "compute_lod")],
        "texture fetch (_bilinear)": [(textures, "_bilinear")],
        "materials, textures and normal map (fetch_bsdf)": [(path, "fetch_bsdf")],
        "BSDF evaluate / pdf / sample": [(uber, "evaluate"), (uber, "pdf"),
                                         (uber, "sample")],
        "lights": [(lights, "pick_light"), (lights, "sample_li"), (lights, "pdf_li"),
                   (lights, "eval_le")],
        "spawn rays": [(path, "spawn_ray"), (path, "spawn_shadow_ray")],
        "accumulate": [(renderer, "accumulate")],
    }


def render(name: str, device, patches=()):
    """SCENE at the parity configuration on ``device``, with ``patches``
    ((owner, attribute, replacement), ...) in place for the render only."""
    from ..config import IntegratorConfig, RenderConfig, SamplerConfig, SamplerType
    from ..renderer import Renderer
    from ..scene import builders

    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=DEPTH))
    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in patches]
    try:
        for owner, attr, fn in patches:
            setattr(owner, attr, fn)
        scene, camera = getattr(builders, name)(device=device)
        return Renderer(scene, camera, cfg, device=device).render().cpu()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _decisions():
    """A patch of ``path._shade`` that records, for each bounce, each
    lane's hit primitive, whether its path goes on, and whether it traces
    a shadow ray; returns (the list it fills, the patch)."""
    from ..integrators import path

    seen, shade = [], path._shade

    def keep(scene, cfg, i, rays, hit, *args, **kw):
        out = shade(scene, cfg, i, rays, hit, *args, **kw)
        seen.append({"hit primitive": hit.prim.cpu(), "path goes on": out[1].active.cpu(),
                     "shadow ray": out[7].cpu()})
        return out
    return seen, (path, "_shade", keep)


def _flips(seen, ref) -> str:
    """The lanes whose decisions differ from the reference render's, per
    bounce."""
    return "; ".join(f"bounce {i}: " + ", ".join(f"{k} {int((a[k] != b[k]).sum())}" for k in a)
                     for i, (a, b) in enumerate(zip(seen, ref)))


def agreement(img: torch.Tensor, ref: torch.Tensor) -> float:
    """``chip_smoke.py``'s parity: the share of pixels agreeing to rtol 1e-3
    / atol 1e-4 in all three channels."""
    return torch.isclose(img, ref, rtol=1e-3, atol=1e-4).all(dim=-1).float().mean().item()


def _lod_lanes(name: str, card):
    """``compute_lod`` of the CPU render's first bounce on both devices."""
    from ..scene import textures

    seen, lod = [], textures.compute_lod

    def keep(*args):
        seen.append(args)
        return lod(*args)

    render(name, "cpu", [(textures, "compute_lod", keep)])
    for i, args in enumerate(seen):
        tex = args[1]
        a, b = lod(*args), lod(*_move(args, card, {})).cpu()
        print(f"[lod] call {i}: {int((tex >= 0).sum())} textured lanes of {tex.numel()}; lod "
              f"differs on {int((a != b).sum())}, its floor (the mip level) on "
              f"{int((a.floor() != b.floor()).sum())}, max |dlod| "
              f"{(a - b).abs().max().item():.3e}", flush=True)


def _ops(card):
    """The share of elements on which each float32 operation that the
    port's shading uses gives other bits on the card than on the CPU, on
    2^20 seeded inputs in the operation's range of use."""
    g = torch.Generator().manual_seed(3)
    pos = torch.rand(1 << 20, generator=g) * 100 + 1e-6
    ang = (torch.rand(1 << 20, generator=g) - 0.5) * 7
    vec = torch.randn((1 << 20, 3), generator=g)
    ops = {
        "rsqrt": (torch.rsqrt, pos), "sqrt": (torch.sqrt, pos), "reciprocal":
        (torch.reciprocal, pos), "log2": (torch.log2, pos), "log": (torch.log, pos),
        "exp": (torch.exp, ang), "sin": (torch.sin, ang), "cos": (torch.cos, ang),
        "tan": (torch.tan, ang * 0.2), "sum of 3 (dot)": (lambda v: (v * v).sum(-1), vec),
        "cross": (lambda v: torch.linalg.cross(v, v.flip(-1), dim=-1), vec),
    }
    for label, (fn, x) in ops.items():
        a, b = fn(x), fn(x.to(card)).cpu()
        bad = a.view(torch.int32) != b.view(torch.int32)
        ulp = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max().item()
        print(f"[ops] {label}: card and CPU bits differ on {bad.float().mean().item():.4%} of "
              f"elements, by up to {ulp} ulp", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("parity_stages: needs a CUDA device", file=sys.stderr)
        return 2
    from ..accel import blocked
    from .card import card_line

    name = argv[0] if argv else "textured_hall"
    card = torch.device("cuda", 0)
    print(card_line(), flush=True)
    with torch.no_grad():
        ref_seen, record = _decisions()
        ref = render(name, "cpu", [record])
        print(f"[render] {name} {SIZE}x{SIZE}, 1 spp, sobol, max_depth {DEPTH}: CPU mean "
              f"{ref.mean().item():.6f}", flush=True)
        cards = {
            "card, kernels": (),
            "card, K4/K5 plain versions on the card": [
                (blocked, "_kernel_or_plain", lambda rays, kernel, plain: plain)],
        }
        for label, patches in cards.items():
            img = render(name, card, patches)
            print(f"[card] {label}: agreement with the CPU {agreement(img, ref):.4f}, mean "
                  f"{img.mean().item():.6f}", flush=True)
        memo = {}
        for label, fns in _stages().items():
            stage = Stage(card, memo)
            patches = [(owner, attr, stage.wrap(owner.__dict__[attr])) for owner, attr in fns]
            seen, record = _decisions()
            img = render(name, "cpu", patches + [record])
            print(f"[hybrid] CPU render with {label} on the card: agreement with the CPU "
                  f"{agreement(img, ref):.4f}; the stage's outputs differ in "
                  f"{stage.differing} of {stage.elements} elements, by up to "
                  f"{stage.max_diff:.3e}; lanes whose decisions differ: "
                  f"{_flips(seen, ref_seen)}", flush=True)
        _lod_lanes(name, card)
        _ops(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
