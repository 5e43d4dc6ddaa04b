"""Where one progressive frame of the main path, or one gradient step,
spends its time, on a GPU.

    python -m mcrt_tpu_torch.tools.profile_frame [SCENE] [--integrator bdpt]
        [--out chiprun_out]
    python -m mcrt_tpu_torch.tools.profile_frame [SCENE] --grad [--integrator bdpt]
        [--out DIR]

It renders SCENE through ``Renderer`` at 512x512, 8 bounces, Sobol, SAH
blocks, with the path tracer (the default) or BDPT: one of the configurations
of ``chip_smoke.py``, namely
``sphere_field`` (the default; 245,764 triangles, the visit-list kernels
K1-K3), ``textured_hall`` (44 textured triangles, the dense kernels K4/K5)
or ``sphere_field_instanced`` (``sphere_field``'s content as 11 instances
of one sphere, the two-level kernels K1, K6, K7).  After one warm-up
frame:

1. Host syncs: one frame under ``torch.cuda.set_sync_debug_mode("warn")``;
   prints every call site in this package that made the host wait for the
   card, with its count.  A frame with none lets the host run ahead of the
   card.
2. Frame times: 5 frames, each bracketed by
   ``torch.cuda.synchronize()``; prints each and the median (ms/spp).
3. Stage times: one frame with both intersector queries and
   ``path._shade`` wrapped in timers that synchronise before and after
   (the syncs add idle time, so the sum exceeds a plain frame); prints each
   bounce's shade, closest-hit and shadow-query time and the live rays.
   Under BDPT the timers wrap the two subpath walks (their closest-hit
   queries included), the four strategy families, each occlusion chunk
   and the t=1 splat; "rest" is the frame outside them (camera rays, the
   visibility masks and sums, the accumulator).
4. Device share: ``torch.profiler`` over two unsynchronised frames; prints
   the wall time, the device time (the summed duration of every event that
   ran on the card: kernels, copies, fills) and the busy share, and the
   kernels with the most device time.  The full table goes to
   ``<out>/profile_frame_<SCENE>_<INTEGRATOR>.txt``.

With ``--grad`` it profiles an inverse-rendering step instead, as
``chip_smoke.py``'s ``[grad]`` phase runs it (``[bdpt_grad]`` under
``--integrator bdpt``): ``full_params``, 1 spp, the
mean squared error against a render of other samples, ``torch.optim.Adam``
(lr 0.05).  After one warm-up step: the host syncs of one step; ``STEPS``
steps, each split by ``torch.cuda.synchronize()`` into forward (the loss),
backward (``loss.backward()``) and optimizer (``Adam.step``) times, with the
median of each and the peak memory; then ``torch.profiler`` over one
unsynchronised step: wall and device time, the busy share, and the kernels
with the most device time (full table in
``<out>/profile_frame_<SCENE>_<INTEGRATOR>_grad.txt``).
"""
from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys
import time
import traceback
import warnings

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SYNC_WARNING = "called a synchronizing CUDA operation"
SIZE, DEPTH, FRAMES = 512, 8, 5
STEPS = 3  # synced gradient steps under --grad
SCENES = ("sphere_field", "textured_hall", "sphere_field_instanced")


def sync_sites(fn) -> collections.Counter:
    """Run ``fn`` with torch's CUDA sync debug mode set to warn; returns,
    with counts, the innermost ``file:line`` of this package on the stack of
    every synchronizing call it made.  ``fn`` must not call
    ``torch.cuda.synchronize()`` itself."""
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(_PKG) and f.filename != __file__]
        where = ours[-1] if ours else traceback.FrameSummary(filename, lineno, "")
        sites[f"{os.path.relpath(where.filename, os.path.dirname(_PKG))}:{where.lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def device_share(run, label, out_path):
    """``run()`` once under ``torch.profiler``, unsynchronised: prints the
    wall time, the device time (the summed duration of every event on the
    card: kernels, copies, fills), the busy share and the 15 kernels with
    the most device time; writes the full table to ``out_path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            on_card[e.name][0] += e.time_range.elapsed_us() / 1e3
            on_card[e.name][1] += 1
    dev_ms = sum(ms for ms, _ in on_card.values())
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms, "
          f"busy {dev_ms / wall_ms:.3f}, "
          f"{sum(n for _, n in on_card.values())} device events")
    for name, (ms, n) in sorted(on_card.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {ms:9.3f} ms  {n:6d} launches  {name[:90]}")
    table = prof.key_averages()
    sort_by = ("self_device_time_total" if hasattr(table[0], "self_device_time_total")
               else "self_cuda_time_total")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(table.table(sort_by=sort_by, row_limit=200))
    print(f"[profile] full table: {out_path}")


def grad_main(args) -> int:
    """``--grad``: one inverse-rendering step split into forward, backward
    and optimizer time (module docstring)."""
    from ..accel import build_intersector
    from ..config import (BuilderType, BVHConfig, IntegratorConfig, IntegratorType,
                          RenderConfig, SamplerConfig, SamplerType)
    from ..diff import estimators
    from ..parallel.render import render_spp_batch
    from ..scene import builders
    from .card import card_line

    device = torch.device("cuda", 0)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       bvh=BVHConfig(builder=BuilderType.SAH),
                       integrator=IntegratorConfig(
                           type=IntegratorType[args.integrator.upper()], max_depth=DEPTH))
    scene, camera = getattr(builders, args.scene)(device=device)
    isect = build_intersector(scene, cfg)
    view = estimators.full_params()
    loss_fn = estimators.render_loss_fn(camera, cfg, isect, view)
    with torch.no_grad():
        target = render_spp_batch(scene, camera, [1000], cfg, isect)
    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}
    opt = torch.optim.Adam(list(params.values()), lr=0.05)
    print(f"{args.scene}: {SIZE}^2, {DEPTH} bounces, 1 spp, {args.integrator}, full_params; "
          f"card {card_line()}")

    def step(sync=False):
        marks = []

        def mark():
            if sync:
                torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, scene, [0], target)
        mark()
        loss.backward()
        mark()
        opt.step()
        mark()
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    step(sync=True)  # warm-up
    sites = sync_sites(step)
    torch.cuda.synchronize()
    print(f"[syncs] {sum(sites.values())} synchronizing calls in one step")
    for site, n in sites.most_common():
        print(f"[syncs]   {n:5d}  {site}")
    torch.cuda.reset_peak_memory_stats(device)
    parts = [step(sync=True) for _ in range(STEPS)]
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    for name, i in (("forward", 0), ("backward", 1), ("optimizer", 2)):
        print(f"[step] {name} {statistics.median(p[i] for p in parts):.2f} ms (median of "
              f"{STEPS}: " + ", ".join(f"{p[i]:.1f}" for p in parts) + ")")
    print(f"[step] a step {statistics.median(sum(p) for p in parts):.2f} ms, peak memory "
          f"{peak:.2f} GiB")
    device_share(step, "one step", os.path.join(
        args.out, f"profile_frame_{args.scene}_{args.integrator}_grad.txt"))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", nargs="?", default="sphere_field", choices=SCENES)
    ap.add_argument("--integrator", default="path", choices=("path", "bdpt"))
    ap.add_argument("--grad", action="store_true",
                    help="profile a gradient step of the integrator instead of a frame")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA device", file=sys.stderr)
        return 2
    if args.grad:
        return grad_main(args)

    from ..accel import Intersector
    from ..config import (BuilderType, BVHConfig, IntegratorConfig, IntegratorType,
                          RenderConfig, SamplerConfig, SamplerType)
    from ..integrators import bdpt, path
    from ..renderer import Renderer
    from ..scene import builders

    device = torch.device("cuda", 0)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=FRAMES + 5,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       bvh=BVHConfig(builder=BuilderType.SAH),
                       integrator=IntegratorConfig(
                           type=IntegratorType[args.integrator.upper()], max_depth=DEPTH))
    scene, camera = getattr(builders, args.scene)(device=device)
    renderer = Renderer(scene, camera, cfg, device=device)
    accel = renderer.intersector.accel
    blocks = getattr(accel, "blas", accel)
    print(f"{args.scene}: {int(scene.geometry.face_valid.sum())} triangles in the face "
          f"table, {type(accel).__name__} of {blocks.num_blocks} blocks, builder "
          f"{blocks.builder}, {SIZE}^2, {DEPTH} bounces, {args.integrator}")
    renderer.step(1)
    torch.cuda.synchronize()

    # 1. host syncs
    sites = sync_sites(lambda: renderer.step(1))
    torch.cuda.synchronize()
    print(f"[syncs] {sum(sites.values())} synchronizing calls in one frame")
    for site, n in sites.most_common():
        print(f"[syncs]   {n:5d}  {site}")

    # 2. frame times
    frame_ms = []
    for _ in range(FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.step(1)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[frames] {statistics.median(frame_ms):.2f} ms/spp (median of {FRAMES}): "
          + ", ".join(f"{t:.1f}" for t in frame_ms))

    # 3. synced stage times
    stages = collections.defaultdict(list)

    def timed(name, fn, live_of):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            stages[name].append(((time.perf_counter() - t0) * 1e3, live_of(*a)))
            return out
        return run

    base = renderer.intersector
    if args.integrator == "path":
        wrapped = {"_shade": timed("shade", path._shade, lambda *a: int(a[5].active.sum()))}
        module, closest = path, timed("closest", base.intersect,
                                      lambda s, r: int(r.active.sum()))
    else:
        def none(*a):
            return 0

        wrapped = {name: timed(stage, getattr(bdpt, name), none) for name, stage in (
            ("generate_camera_subpath", "camera walk"), ("generate_light_subpath", "light walk"),
            ("_family_s0", "s=0"), ("_family_s1", "s=1"), ("_family_connect", "s,t>=2"),
            ("_family_t1", "t=1"), ("_splat", "splat"))}
        module, closest = bdpt, base.intersect
    own = {name: getattr(module, name) for name in wrapped}
    renderer.intersector = Intersector(
        closest, timed("shadow", base.occluded, lambda s, r: int(r.active.sum())), base.accel)
    for name, fn in wrapped.items():
        setattr(module, name, fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        renderer.step(1)
    finally:
        renderer.intersector = base
        for name, fn in own.items():
            setattr(module, name, fn)
    torch.cuda.synchronize()
    synced_ms = (time.perf_counter() - t0) * 1e3
    totals = {k: sum(ms for ms, _ in v) for k, v in stages.items()}
    print(f"[stages] synced frame {synced_ms:.1f} ms: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in totals.items())
        + f", rest {synced_ms - sum(totals.values()):.1f} ms")
    if args.integrator == "path":
        for i in range(len(stages["shade"])):
            row = ", ".join(f"{k} {stages[k][i][0]:.2f} ms ({stages[k][i][1]} live)"
                            for k in ("closest", "shade", "shadow") if i < len(stages[k]))
            print(f"[stages]   bounce {i}: {row}")
    else:
        for i, (ms, live) in enumerate(stages["shadow"]):
            print(f"[stages]   occlusion chunk {i}: {ms:.2f} ms ({live} live shadow rays)")

    # 4. device share over two unsynced frames
    device_share(lambda: renderer.step(2), "2 frames",
                 os.path.join(args.out, f"profile_frame_{args.scene}_{args.integrator}.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
