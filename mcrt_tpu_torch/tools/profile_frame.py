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
3. Stages: one unsynchronised frame under ``utils/profiling.device_trace``,
   read from the program's own ``mcrt.*`` spans.  For the path tracer,
   each bounce's host time of shading (``mcrt.shade``) and of the
   closest-hit and shadow queries (``mcrt.query.closest`` /
   ``.occluded``), with the device time of the work launched inside each;
   under BDPT the same for the two walks, the four strategy families, the
   t=1 splat, the staged occlusion (``mcrt.bdpt.*``) and each occlusion
   chunk, then the shadow rays staged, live and the chunk queries that
   took them.  The live rays come from ``profiling.tallies()``, the
   staged rays and chunks from ``profiling.counts()``, and
   ``RenderMetrics``' rays/s puts the live rays over stage 2's median
   frame.
4. Device share, from the same trace: the frame's wall time, its device
   busy time (the union of every kernel, copy and fill interval on the
   card) and the busy share, and the kernels with the most device time.
   The full table goes to ``<out>/profile_frame_<SCENE>_<INTEGRATOR>.txt``.
5. The renderer's shading graphs: ``Renderer.shade_graph_stats()`` after
   every frame above (captures, replays, bounces run eagerly).

With ``--grad`` it profiles an inverse-rendering step instead, as
``chip_smoke.py``'s ``[grad]`` phase runs it (``[bdpt_grad]`` under
``--integrator bdpt``): ``full_params``, 1 spp, the
mean squared error against a render of other samples, ``torch.optim.Adam``
(lr 0.05).  After one warm-up step: the host syncs of one step; ``STEPS``
steps, each split by CUDA events recorded between its forward (the loss),
backward (``loss.backward()``) and optimizer (``Adam.step``) on the card's
timeline, read after one sync at the step's end, with the median of each
and the peak memory; then the device share of one unsynchronised step, as
stage 4 (full table in ``<out>/profile_frame_<SCENE>_<INTEGRATOR>_grad.txt``).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import glob
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
import warnings

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SYNC_WARNING = "called a synchronizing CUDA operation"
SIZE, DEPTH, FRAMES = 512, 8, 5
STEPS = 3  # gradient steps timed under --grad
SCENES = ("sphere_field", "textured_hall", "sphere_field_instanced")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BDPT_STAGES = ("camera_walk", "light_walk", "s0", "s1", "connect", "t1", "splat")


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


def traced(run):
    """``run()`` once under ``utils/profiling.device_trace``, with no sync
    inside it: (wall ms to a sync after it, the Chrome trace's events, the
    profiler)."""
    from ..utils import profiling

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        (path,) = glob.glob(os.path.join(tmp, "trace-*.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return wall_ms, events, prof


def read_trace(events):
    """(spans, device) from Chrome-trace events: ``spans`` maps each
    ``mcrt.*`` span's name to ``[(host ms, device ms)]`` in the order the
    spans opened, the device time being that of the work launched inside
    the span; ``device`` lists ``(name, ts, dur)`` (us) of every kernel,
    copy and fill."""
    launches, by_corr, device = [], {}, []
    opened = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((name, ts, dur))
            if corr is not None:
                by_corr[corr] = by_corr.get(corr, 0.0) + dur
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches.append((ts, corr))
        elif cat == "user_annotation" and name.startswith("mcrt."):
            opened[name].append((ts, dur))
    launches.sort()
    starts = [ts for ts, _ in launches]
    spans = {}
    for name, items in opened.items():
        rows = []
        for ts, dur in sorted(items):
            lo, hi = bisect.bisect_left(starts, ts), bisect.bisect_right(starts, ts + dur)
            dev_us = sum(by_corr.get(launches[i][1], 0.0) for i in range(lo, hi))
            rows.append((dur / 1e3, dev_us / 1e3))
        spans[name] = rows
    return spans, device


def busy_ms(device) -> float:
    """The union of the device intervals, in ms: time the card ran at least
    one op, overlaps counted once."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(device, key=lambda d: d[1]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            total += hi - lo
        end = max(end, hi)
    return total / 1e3


def device_share(wall_ms, device, prof, label, out_path):
    """Prints the wall time, the device busy time (``busy_ms``), the busy
    share and the 15 kernels with the most device time of one traced run;
    writes the profiler's full table to ``out_path``."""
    on_card = collections.defaultdict(lambda: [0.0, 0])
    for name, _, dur in device:
        on_card[name][0] += dur / 1e3
        on_card[name][1] += 1
    busy = busy_ms(device)
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
          f"busy share {busy / wall_ms:.3f}, {len(device)} device events")
    for name, (ms, n) in sorted(on_card.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile]   {ms:9.3f} ms  {n:6d} launches  {name[:90]}")
    table = prof.key_averages()
    sort_by = ("self_device_time_total" if hasattr(table[0], "self_device_time_total")
               else "self_cuda_time_total")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(table.table(sort_by=sort_by, row_limit=200))
    print(f"[profile] full table: {out_path}")


def stage_lines(spans, integrator: str) -> list:
    """Stage 3's lines from ``read_trace``'s spans: each bounce's shading
    and queries (path tracer) or each BDPT stage and occlusion chunk, then
    every ``mcrt.*`` span's count and totals."""

    def cell(label, row):
        return f"{label} {row[0]:.2f} ms host, {row[1]:.2f} ms device"

    lines = []
    if integrator == "path":
        cols = [(k, spans.get(f"mcrt.{k}", [])) for k in ("query.closest", "shade",
                                                            "query.occluded")]
        for i in range(max(len(rows) for _, rows in cols)):
            lines.append(f"bounce {i}: " + ", ".join(cell(k, rows[i]) for k, rows in cols
                                                     if i < len(rows)))
    else:
        for k in BDPT_STAGES:
            for row in spans.get(f"mcrt.bdpt.{k}", []):
                lines.append(cell(k, row))
        for row in spans.get("mcrt.bdpt.occlusion", []):
            lines.append(cell("occlusion (staging and chunks)", row))
        for i, row in enumerate(spans.get("mcrt.query.occluded", [])):
            lines.append(cell(f"occlusion chunk {i}", row))
    for name in sorted(spans):
        rows = spans[name]
        lines.append(f"{name}: {len(rows)} spans, " + cell(
            "total", (sum(r[0] for r in rows), sum(r[1] for r in rows))))
    return lines


def print_stages(spans, integrator, frame_ms):
    """Stage 3: ``stage_lines``, under BDPT the shadow rays staged, live and
    the chunk queries, the live rays the queries tallied, and
    ``RenderMetrics``' rays/s over a frame of ``frame_ms``."""
    from ..utils import profiling

    for line in stage_lines(spans, integrator):
        print(f"[stages] {line}")
    live = profiling.tallies()
    if integrator == "bdpt":
        n = profiling.counts()
        print(f"[stages] shadow rays: {n.get('bdpt.staged_rays', 0)} staged, "
              f"{live.get('rays.occluded', 0)} live, in "
              f"{n.get('bdpt.occlusion_chunks', 0)} chunk queries")
    rays = profiling.RenderMetrics(rays_traced=float(sum(live.values())), samples=1,
                                   render_s=frame_ms / 1e3)
    print(f"[stages] live rays {live}; {rays.rays_per_sec() / 1e6:.1f} Mrays/s at "
          f"{frame_ms:.2f} ms a frame")


def grad_main(args) -> int:
    """``--grad``: one inverse-rendering step split into forward, backward
    and optimizer time (module docstring)."""
    from ..accel import build_intersector
    from ..config import (BuilderType, BVHConfig, IntegratorConfig, IntegratorType,
                          RenderConfig, SamplerConfig, SamplerType)
    from ..diff import estimators
    from ..parallel.render import render_spp_batch
    from ..scene import builders
    from ..utils import profiling
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

    def step(timed=False):
        """One step; with ``timed``, the card's milliseconds of its forward,
        backward and optimizer, from CUDA events read after one sync at its
        end."""
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if timed else []

        def mark(i):
            if marks:
                marks[i].record()

        mark(0)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, scene, [0], target)
        mark(1)
        loss.backward()
        mark(2)
        opt.step()
        mark(3)
        if not marks:
            return None
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    step()  # warm-up
    torch.cuda.synchronize()
    sites = sync_sites(step)
    torch.cuda.synchronize()
    print(f"[syncs] {sum(sites.values())} synchronizing calls in one step")
    for site, n in sites.most_common():
        print(f"[syncs]   {n:5d}  {site}")
    torch.cuda.reset_peak_memory_stats(device)
    parts = [step(timed=True) for _ in range(STEPS)]
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    for name, i in (("forward", 0), ("backward", 1), ("optimizer", 2)):
        print(f"[step] {name} {statistics.median(p[i] for p in parts):.2f} ms (median of "
              f"{STEPS}: " + ", ".join(f"{p[i]:.1f}" for p in parts) + ")")
    print(f"[step] a step {statistics.median(sum(p) for p in parts):.2f} ms, peak memory "
          f"{peak:.2f} GiB")
    wall_ms, events, prof = traced(step)
    print(f"[profile] live rays in the step: {profiling.tallies()}")
    device_share(wall_ms, read_trace(events)[1], prof, "one step", os.path.join(
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

    from ..config import (BuilderType, BVHConfig, IntegratorConfig, IntegratorType,
                          RenderConfig, SamplerConfig, SamplerType)
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

    # 3. and 4. stages and device share, from one unsynchronised traced frame
    wall_ms, events, prof = traced(lambda: renderer.step(1))
    spans, device_events = read_trace(events)
    print_stages(spans, args.integrator, statistics.median(frame_ms))
    device_share(wall_ms, device_events, prof, "1 frame",
                 os.path.join(args.out, f"profile_frame_{args.scene}_{args.integrator}.txt"))
    print(f"[graphs] {renderer.shade_graph_stats()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
