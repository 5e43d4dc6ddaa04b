"""Where one progressive frame of the main path spends its time, on a GPU.

    python -m mcrt_tpu_torch.tools.profile_frame [SCENE] [--out chiprun_out]

It renders SCENE through ``Renderer`` at 512x512, 8 bounces, Sobol, SAH
blocks: one of the main-path configurations of ``chip_smoke.py``, namely
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
4. Device share: ``torch.profiler`` over two unsynchronised frames; prints
   the wall time, the device time (the summed duration of every event that
   ran on the card: kernels, copies, fills) and the busy share, and the
   kernels with the most device time.  The full table goes to
   ``<out>/profile_frame_<SCENE>.txt``.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", nargs="?", default="sphere_field", choices=SCENES)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA device", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..accel import Intersector
    from ..config import (BuilderType, BVHConfig, IntegratorConfig, RenderConfig,
                          SamplerConfig, SamplerType)
    from ..integrators import path
    from ..renderer import Renderer
    from ..scene import builders

    device = torch.device("cuda", 0)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=FRAMES + 5,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       bvh=BVHConfig(builder=BuilderType.SAH),
                       integrator=IntegratorConfig(max_depth=DEPTH))
    scene, camera = getattr(builders, args.scene)(device=device)
    renderer = Renderer(scene, camera, cfg, device=device)
    accel = renderer.intersector.accel
    blocks = getattr(accel, "blas", accel)
    print(f"{args.scene}: {int(scene.geometry.face_valid.sum())} triangles in the face "
          f"table, {type(accel).__name__} of {blocks.num_blocks} blocks, builder "
          f"{blocks.builder}, {SIZE}^2, {DEPTH} bounces")
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

    base, shade = renderer.intersector, path._shade
    renderer.intersector = Intersector(
        timed("closest", base.intersect, lambda s, r: int(r.active.sum())),
        timed("shadow", base.occluded, lambda s, r: int(r.active.sum())),
        base.accel)
    path._shade = timed("shade", shade, lambda *a: int(a[5].active.sum()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        renderer.step(1)
    finally:
        renderer.intersector, path._shade = base, shade
    torch.cuda.synchronize()
    synced_ms = (time.perf_counter() - t0) * 1e3
    totals = {k: sum(ms for ms, _ in v) for k, v in stages.items()}
    print(f"[stages] synced frame {synced_ms:.1f} ms: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in totals.items())
        + f", rest {synced_ms - sum(totals.values()):.1f} ms")
    for i in range(len(stages["shade"])):
        row = ", ".join(f"{k} {stages[k][i][0]:.2f} ms ({stages[k][i][1]} live)"
                        for k in ("closest", "shade", "shadow") if i < len(stages[k]))
        print(f"[stages]   bounce {i}: {row}")

    # 4. device share over two unsynced frames
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.step(2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            on_card[e.name][0] += e.time_range.elapsed_us() / 1e3
            on_card[e.name][1] += 1
    dev_ms = sum(ms for ms, _ in on_card.values())
    print(f"[profile] 2 frames: wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms, "
          f"busy {dev_ms / wall_ms:.3f}, "
          f"{sum(n for _, n in on_card.values())} device events")
    for name, (ms, n) in sorted(on_card.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {ms:9.3f} ms  {n:6d} launches  {name[:90]}")
    table = prof.key_averages()
    sort_by = ("self_device_time_total" if hasattr(table[0], "self_device_time_total")
               else "self_cuda_time_total")
    os.makedirs(args.out, exist_ok=True)
    path_out = os.path.join(args.out, f"profile_frame_{args.scene}.txt")
    with open(path_out, "w") as f:
        f.write(table.table(sort_by=sort_by, row_limit=200))
    print(f"[profile] full table: {path_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
