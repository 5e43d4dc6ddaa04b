"""The intersector kernels of several source trees, timed on the same
inputs in one process on one GPU.

    python -m mcrt_tpu_torch.tools.tree_ab [NAME=DIR ...] [--rounds 2] [--reps 5]
                                           [--kernels K1,K2,K3,K4,K5,K6,K7]
    python -m mcrt_tpu_torch.tools.tree_ab [NAME=DIR ...] --kernels K8,K9

Each DIR is the root of a copy of this repository; only its
``mcrt_tpu_torch/csrc`` is read, and it must keep this tree's C entry
points.  ``this`` (this tree) is always among the trees, first.  Every
tree's sources are built with this tree's flags into a library of their
own, and each tree's kernels run through this tree's wrappers (the
wrappers' ``kernels.LIBRARY`` is swapped for the tree's).  The inputs are
made once, by this tree's Python code, for the scenes of the kernels that
``--kernels`` names:

- ``sphere_field`` (245,764 triangles): the 512x512 primary and bounce
  wavefronts of ``chip_smoke.py``; K1, then K2 and K3 on its visit lists;
  and the inputs that K1 is handed during one frame (``Renderer``,
  512x512, 8 bounces, Sobol, SAH blocks, after one warm-up frame): 16
  launches, summed;
- ``textured_hall`` (44 triangles in one 128-slot block): K4 and K5 on
  the same two wavefronts, packed as the main path packs them (unsorted:
  the queries sort only from ``SORT_MIN_BLOCKS`` blocks on), and
  the inputs K4 and K5 are handed during one frame (as above; 8 launches
  each, summed);
- ``sphere_field_instanced``: the same two wavefronts; K1 over the pair
  boxes, then K6 and K7;
- the card micro-benchmark (``vpu_bench``, only when ``--kernels`` names
  K8 or K9, which the default list does not): K8's bfloat16 and float32
  chains on its (256, 1024) input and K9's products at k = 8 and 128, each
  ``vpu_bench.ITERS`` passes in one launch.

A round times every case of every tree, each case as the median of
``--reps`` calls, each call bracketed by ``torch.cuda.synchronize()`` and
timed with CUDA events on the card alone (the window queued behind a spin
on the card, ``card.device_timed``); the trees' order is reversed every
other round (``this, a, b, b, a, this``), so drift in the card's clock
does not favour a tree.  Prints each tree's time for each case in each round and the mean
over rounds.  K1's keys and K4/K5's and K8's outputs must equal this
tree's (``torch.equal``: those kernels are exact), K9's must lie within the
dot-product bound ``2 * k * 2**-24 * (|a| @ |b|)`` of this tree's (its
elements that differ in any bit are printed); the walks' outputs are
compared with this tree's and their differing rays printed.  Each launch
of a case of several (a frame's launches) is printed too, with its live
rays (and, for K1, live tiles and entered (tile, chunk) pairs).  The
card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

import torch

def _frame_renderer(scene, camera, device):
    """A ``Renderer`` at 512x512, 8 bounces, Sobol, SAH blocks, after one
    warm-up frame."""
    from ..config import BuilderType, BVHConfig, IntegratorConfig, RenderConfig, SamplerConfig
    from ..config import SamplerType
    from ..renderer import Renderer
    from .wavefronts import HEIGHT, WIDTH

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=4,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       bvh=BVHConfig(builder=BuilderType.SAH),
                       integrator=IntegratorConfig(max_depth=8))
    renderer = Renderer(scene, camera, cfg, device=device)
    renderer.step(1)  # warm-up
    return renderer


def _flat_cases(device, cases):
    from ..accel import blocked, kernels
    from ..scene.builders import sphere_field
    from .wavefronts import inputs_of, wavefronts

    tile, group = blocked.TILE, blocked.GROUP
    scene, camera = sphere_field(device=device)
    accel = blocked.build_blocked(scene.geometry)
    waves = wavefronts(camera, lambda r: blocked.intersect_blocked(scene.geometry, accel, r),
                       device)
    for wf, rays in waves.items():
        packed, _ = blocked._sorted_table(rays, accel, True)
        k1 = (packed, accel.chunk_aabb, accel.aabb, tile)
        counts, lists, tn = blocked.lists_from_keys(kernels.cull(*k1))
        cases[f"K1 {wf}"] = ("K1", [k1])
        cases[f"K2 {wf}"] = ("K2", [(counts, packed, lists, tn, accel.tri, accel.aabb, tile,
                                     group)])
        cases[f"K3 {wf}"] = ("K3", [(counts, packed, lists, accel.tri, accel.aabb, tile,
                                     group)])
    renderer = _frame_renderer(scene, camera, device)
    cases["K1 frame"] = ("K1", inputs_of(lambda: renderer.step(1), ["K1"])["K1"])


def _dense_cases(device, cases):
    from ..accel import SORT_MIN_BLOCKS, blocked
    from ..scene.builders import textured_hall
    from .wavefronts import inputs_of, wavefronts

    scene, camera = textured_hall(device=device)
    accel = blocked.build_blocked(scene.geometry)
    waves = wavefronts(camera, lambda r: blocked.intersect_blocked(scene.geometry, accel, r),
                       device)
    for wf, rays in waves.items():
        # packed as the main path packs them: unsorted below SORT_MIN_BLOCKS
        packed, _ = blocked._sorted_table(rays, accel, accel.num_blocks >= SORT_MIN_BLOCKS)
        cases[f"K4 {wf}"] = ("K4", [(packed, accel.tri)])
        cases[f"K5 {wf}"] = ("K5", [(packed, accel.tri)])
    renderer = _frame_renderer(scene, camera, device)
    frame = inputs_of(lambda: renderer.step(1), ["K4", "K5"])
    cases["K4 frame"] = ("K4", frame["K4"])
    cases["K5 frame"] = ("K5", frame["K5"])


def _two_level_cases(device, cases):
    from ..accel import blocked, kernels
    from ..accel import two_level as tl
    from ..scene.builders import sphere_field_instanced
    from .wavefronts import wavefronts

    tile, group = blocked.TILE, blocked.GROUP
    scene, camera = sphere_field_instanced(device=device)
    two = tl.build_two_level_scene(scene.geometry, scene.shapes.to_world, scene.instances)
    args = (two.blas.tri, two.pair_code, two.tw_rows)
    waves = wavefronts(camera, lambda r: tl.intersect_two_level(scene.geometry, two, r),
                       device)
    for wf, rays in waves.items():
        packed, _ = blocked._sorted_table(rays, two, True)
        k1 = (packed, two.pair_chunk, two.pair_aabb, tile)
        counts, lists, tn = blocked.lists_from_keys(kernels.cull(*k1))
        cases[f"K1 pairs {wf}"] = ("K1", [k1])
        cases[f"K6 {wf}"] = ("K6", [(counts, packed, lists, tn, *args, two.pair_aabb, tile,
                                     group)])
        cases[f"K7 {wf}"] = ("K7", [(counts, packed, lists, *args, two.pair_aabb, tile,
                                     group)])


def _vpu_cases(device, cases):
    from . import vpu_bench as vb

    x = vb.chain_input(device)
    for dtype in (torch.bfloat16, torch.float32):
        cases[f"K8 {str(dtype).split('.')[-1]}"] = ("K8", [(x.to(dtype).contiguous(), vb.ITERS)])
    for k in vb.KS:
        cases[f"K9 k={k}"] = ("K9", [(*vb.matmul_inputs(device, k), vb.ITERS)])


# the case builders, by the kernels their cases time
SCENES = ((("K1", "K2", "K3"), _flat_cases), (("K4", "K5"), _dense_cases),
          (("K1", "K6", "K7"), _two_level_cases), (("K8", "K9"), _vpu_cases))
ALL = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")  # the default --kernels
EXACT = ("K1", "K4", "K5", "K8")  # kernels whose every output must equal this tree's


def _inputs(device, wanted):
    """The cases of the kernels ``wanted``: name -> (kernel id, list of
    argument tuples)."""
    cases = {}
    for ids, build in SCENES:
        if wanted & set(ids):
            build(device, cases)
    torch.cuda.synchronize()
    return {c: v for c, v in cases.items() if v[0] in wanted}


def _differing(k, out, ref) -> int:
    """Outputs that differ from this tree's: keys (K1), elements in any
    bit (K8, K9), rays (the rest)."""
    if k == "K1":
        return int((out != ref).sum())
    if k in ("K8", "K9"):
        view = torch.int16 if out.dtype == torch.bfloat16 else torch.int32
        return int((out.view(view) != ref.view(view)).sum())
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    bad = torch.zeros_like(out[0], dtype=torch.bool)
    for a, b in zip(out, ref):
        bad |= a != b
    return int(bad.sum())


def _within_dot_bound(name, case, out, ref, a, b):
    """K9's output within ``2 * k * 2**-24 * (|a| @ |b|)`` of this tree's."""
    tol = 2 * a.shape[1] * 2.0**-24 * (a.double().abs() @ b.double().abs())
    if not bool(((out.double() - ref.double()).abs() <= tol).all()):
        raise AssertionError(f"{name}: {case} leaves the dot-product bound of this tree's")


def run(libs: dict, device, rounds: int, reps: int, wanted=frozenset(ALL)) -> dict:
    """Every case of the kernels ``wanted`` under every library of ``libs``
    (name -> KernelLibrary, ``this`` first), ``rounds`` times; returns
    {tree: {case: [ms, ...]}}."""
    from ..accel import kernels
    from .card import device_timed

    own = kernels.LIBRARY
    times = {name: {} for name in libs}
    each = {name: {} for name in libs}  # per launch of a case of several, last round
    with torch.no_grad():
        cases = _inputs(device, set(wanted))
        refs = {c: [kernels.WRAPPERS[k](*a) for a in inputs] for c, (k, inputs) in cases.items()}
        order = list(libs)
        try:
            for rnd in range(rounds):
                for name in (order if rnd % 2 == 0 else order[::-1]):
                    kernels.LIBRARY = libs[name]
                    for case, (k, inputs) in cases.items():
                        fn = kernels.WRAPPERS[k]
                        per = [device_timed(lambda: fn(*a), reps)[0] for a in inputs]
                        ms = sum(per)
                        each[name][case] = per
                        outs = [fn(*a) for a in inputs]
                        diff = sum(_differing(k, o, r) for o, r in zip(outs, refs[case]))
                        if k in EXACT and diff:
                            raise AssertionError(f"{name}: {case} outputs differ from this "
                                                 f"tree's ({diff})")
                        if k == "K9":
                            for a, o, r in zip(inputs, outs, refs[case]):
                                _within_dot_bound(name, case, o, r, *a[:2])
                        times[name].setdefault(case, []).append(ms)
                        print(f"[round {rnd}] {name} {case} ({len(inputs)} launches): "
                              f"{ms:.4f} ms, differing from this tree {diff}", flush=True)
        finally:
            kernels.LIBRARY = own
    print("mean over rounds (ms):", flush=True)
    for case in cases:
        print(f"  {case:18s} " + "  ".join(
            f"{name} {statistics.fmean(times[name][case]):.4f}" for name in libs), flush=True)
    for case, (k, inputs) in cases.items():
        if len(inputs) < 2:
            continue
        print(f"{case}, each launch (ms, last round):", flush=True)
        for i, (a, ref) in enumerate(zip(inputs, refs[case])):
            stats = ""
            if k == "K1":
                tmn, tmx = a[0][6], a[0][7]
                live = ~(tmx < tmn)
                tiles = int(live.reshape(-1, a[3]).any(dim=1).sum())
                entered = int((ref < 0.5 * 3.0e38).reshape(ref.shape[0], -1, 128).any(dim=2).sum())
                stats = (f" ({int(live.sum())} live rays, {tiles} live tiles, {entered} "
                         f"entered (tile, chunk) pairs)")
            elif k in ("K4", "K5"):
                stats = f" ({int((a[0][7] > a[0][6]).sum())} live rays)"
            print(f"  {i:2d}: " + "  ".join(f"{name} {each[name][case][i]:.4f}" for name in libs)
                  + stats, flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", default=",".join(ALL),
                    help="comma-separated kernel ids whose cases are timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tree_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from ..accel import kernels
    from .card import card_line

    print(card_line(), flush=True)
    libs = {"this": kernels.LIBRARY}
    for spec in args.trees:
        name, _, root = spec.partition("=")
        libs[name] = kernels.KernelLibrary(os.path.join(root, "mcrt_tpu_torch", "csrc"))
    for name, lib in libs.items():
        lib.get()
        print(f"[build] {name}: {lib.path}", flush=True)
    run(libs, torch.device("cuda", 0), args.rounds, args.reps,
        frozenset(args.kernels.split(",")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
