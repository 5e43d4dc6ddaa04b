"""Progressive rendering: ``Renderer.step(1)`` in a closed loop, one sample
per pixel a frame, no host sync inside the window.

End to end: ``spp_ms`` (the window's wall time, one sync at its end, over
its samples), ``frame_ms_p90`` (the 90th percentile of every frame's time
between CUDA events recorded after consecutive frames) and ``setup_s``.
The check: the film at pixels drawn from the seed against the reference's
film over the same samples.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import checks, port, stats, trace
from . import Mark, Outcome, first_frame, peak_bytes, sync, trace_start


def _window(r, seconds: float, trace_frames: int, masks: dict):
    """The timed frames: (frames, wall s, frame ms list, traced Record).
    A traced run profiles ``trace_frames`` more after the window's frames
    (run on to ``trace_start``): the profiler slows the host's launches
    after it stops as well, so the untraced frames go first and time the
    traced ones' untraced cost."""
    dev, f0 = r.device, r.accum.frame
    frames, rec = 0, None
    sync(dev)
    marks = [Mark(dev)]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        r.step(1)
        marks.append(Mark(dev))
        frames += 1
    if trace_frames:
        start = trace_start(frames, trace_frames, f0, 1)
        while frames < start:
            r.step(1)
            marks.append(Mark(dev))
            frames += 1
        sync(dev)
        untraced = trace.untraced_s(trace_frames, time.perf_counter() - t0, frames)
        base = r.intersector
        r.intersector = port.spanned_intersector(base, masks)

        def traced_frames():
            for _ in range(trace_frames):
                r.step(1)
            return trace_frames

        rec = trace.Traced(traced_frames, "progressive", lambda: sync(dev))
        r.intersector = base
        frames += trace_frames
    sync(dev)
    wall = time.perf_counter() - t0
    frame_ms = [a.ms_to(b) for a, b in zip(marks, marks[1:])]
    if rec is not None:
        rec = rec.record()
        rec.untraced_s = untraced
    return frames, wall, frame_ms, rec


def check_pixels(seed: int, traffic: dict, n_px: int, dev) -> torch.Tensor:
    """The pixels a run checks: ``check_pixels`` of them, drawn from the seed."""
    pixels = np.random.default_rng(seed).choice(n_px, int(traffic["check_pixels"]),
                                                replace=False)
    return torch.as_tensor(np.sort(pixels), device=dev)


def control(ctx, low, frames: int) -> dict:
    """The numbers a run compares, with ``low`` (the reference in a lower
    precision) in the program's place, over ``frames`` samples from the
    seed's first frame."""
    f0 = first_frame(ctx.seed, ctx.traffic)
    render = ctx.config["render"]
    pix = check_pixels(ctx.seed, ctx.traffic, render["width"] * render["height"], ctx.device)
    fr = list(range(f0, f0 + frames))
    ref = ctx.reference.film(ctx.spec, render, pix, fr).cpu()
    prog = low.film(ctx.spec, render, pix, fr).cpu()
    return {"pixels_off": checks.pixels_off(prog, ref), "mean_rel": checks.mean_rel(prog, ref),
            "frames_missing": 0, **checks.describe(prog, ref)}


def run(ctx) -> Outcome:
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    r = port.renderer(ctx.spec, cfg["render"], dev)
    r.step(int(traffic["warm_frames"]))  # loads the kernels, warms every shape
    f0 = first_frame(ctx.seed, traffic)
    r.reset()
    r.accum = r.accum.replace(frame=f0)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    masks = {}
    trace_frames = int(traffic["trace_frames"]) if ctx.trace else 0
    frames, wall, frame_ms, rec = _window(r, ctx.seconds, trace_frames, masks)
    peak = peak_bytes(dev)
    if rec is not None:
        live = {k: int(sum(int(m.sum()) for m in v)) for k, v in masks.items()}
        calls = sum(len(v) for v in masks.values())
        rec.counters.update(
            live_closest=live.get("intersect", 0), live_occluded=live.get("occluded", 0),
            queries=calls, triangles=ctx.spec.num_faces,
            query_bytes=stats.query_bytes(live.get("intersect", 0), live.get("occluded", 0),
                                          calls, ctx.spec.num_faces))
    masks.clear()

    pix_t = check_pixels(ctx.seed, traffic, r.cfg.width * r.cfg.height, dev)
    prog = r.accum.image.reshape(-1, 3)[pix_t].cpu()
    done = r.accum.frame
    del r
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    values = {"frames_missing": abs(done - (f0 + frames))}
    notes = {}
    if values["frames_missing"]:
        # the film is not of the frames the window drove: not correct, and
        # no reference is worth rendering for it
        values.update(pixels_off=float("nan"), mean_rel=float("nan"))
    else:
        t_ref = time.perf_counter()
        ref = ctx.reference.film(ctx.spec, cfg["render"], pix_t,
                                 list(range(f0, f0 + frames))).cpu()
        notes = checks.describe(prog, ref)
        notes["reference_s"] = time.perf_counter() - t_ref
        values.update(pixels_off=checks.pixels_off(prog, ref),
                      mean_rel=checks.mean_rel(prog, ref))
    e2e = {"spp_ms": stats.per_item_ms(wall, frames),
           "frame_ms_p90": stats.percentile(frame_ms, 90.0) if frame_ms else float("nan"),
           "setup_s": setup_s}
    return Outcome(end_to_end=e2e, values=values, attempted=frames, record=rec,
                   memory_peak_bytes=peak, notes=notes)
