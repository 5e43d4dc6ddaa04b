"""The sample-sharded render: ranks started by ``parallel.mesh.spawn_ranks``
over an (n, 1) ``DeviceMesh``, each batch ``render_spp_batch`` with the
mesh (one sample a rank, their mean an ``all_reduce``), the progressive
mean kept on every rank.  No host sync inside the window.

The ranks agree on where the window ends without a sync: rank 0, once its
clock passes ``--seconds``, posts a batch count ``STOP_LAG`` batches ahead
in a file store, every rank reads the store before each batch, and all stop
after that count.  A rank's host runs at most a batch or two ahead of the
slowest device, since each batch ends in a collective.

End to end: ``spp_ms``, rank 0's wall time over the samples of every rank,
and ``setup_s``.  The check: rank 0's progressive mean at pixels drawn from
the seed against the reference's mean over the same samples, and every
rank's mean against rank 0's, which must be equal.
"""
from __future__ import annotations

import gc
import os
import pickle
import shutil
import tempfile
import time

import torch

from .. import checks, port, stats, trace
from . import Outcome, first_frame, peak_bytes, sync, trace_start
from .progressive import check_pixels

STOP_LAG = 4


def control(ctx, low, batches: int) -> dict:
    """The numbers a run compares, with ``low`` (the reference in a lower
    precision) in the program's place, over ``batches`` batches of the
    cell's ranks from the seed's first frame."""
    render = ctx.config["render"]
    pix = check_pixels(ctx.seed, ctx.traffic, render["width"] * render["height"], ctx.device)
    f0 = first_frame(ctx.seed, ctx.traffic)
    fr = list(range(f0, f0 + batches * ctx.chips * int(ctx.traffic["samples_per_rank"])))
    ref = ctx.reference.mean(ctx.spec, render, pix, fr).cpu()
    prog = low.mean(ctx.spec, render, pix, fr).cpu()
    return {"pixels_off": checks.pixels_off(prog, ref), "mean_rel": checks.mean_rel(prog, ref),
            "ranks_disagree": 0.0, **checks.describe(prog, ref)}


def run(ctx) -> Outcome:
    from mcrt_tpu_torch.parallel.mesh import spawn_ranks

    tmp = tempfile.mkdtemp(prefix="perfbench_ranks_")
    try:
        job = {k: getattr(ctx, k) for k in ("seed", "seconds", "trace", "config", "traffic",
                                            "chips", "t_start")}
        job.update(device=ctx.device.type, tmp=tmp, reference=ctx.reference)
        spawn_ranks(_rank, ctx.chips, args=(job,),
                    device="cpu" if ctx.device.type == "cpu" else None,
                    init_method=f"file://{os.path.join(tmp, 'group')}",
                    timeout=float(ctx.traffic["rank_timeout_s"]))
        with open(os.path.join(tmp, "outcome.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        stop_resource_tracker()
        shutil.rmtree(tmp, ignore_errors=True)


def stop_resource_tracker():
    """Stop the ``multiprocessing`` resource tracker that the ``spawn`` start
    method started in this process, and wait until it has ended: left alone,
    it ends only after this process has exited, and so outlives the run."""
    from multiprocessing import resource_tracker

    rt = resource_tracker._resource_tracker
    if hasattr(rt, "_stop"):
        rt._stop()
    elif rt._pid is not None:
        os.close(rt._fd)
        os.waitpid(rt._pid, 0)
        rt._fd = rt._pid = None


def _rank(rank: int, job: dict):
    import torch.distributed as dist

    from mcrt_tpu_torch.accel import build_intersector
    from mcrt_tpu_torch.parallel.mesh import make_mesh
    from mcrt_tpu_torch.parallel.render import render_spp_batch

    from .. import scenes

    torch.set_num_threads(1)
    world, traffic = job["chips"], job["traffic"]
    dev = torch.device("cpu") if job["device"] == "cpu" else torch.device("cuda", rank)
    spec = scenes.load(job["config"]["scene"], job["config"].get("scene_args"))
    scene, cam = port.scene(spec, dev)
    cfg = port.render_config(job["config"]["render"])
    isect = build_intersector(scene, cfg)
    mesh = make_mesh(n_spp=world, n_rays=1, device=dev)
    per = int(traffic["samples_per_rank"])
    for w in range(int(traffic["warm_batches"])):  # loads the kernels, warms every shape
        render_spp_batch(scene, cam, range(w * world * per, (w + 1) * world * per), cfg,
                         isect, mesh)
    f0 = first_frame(job["seed"], traffic)
    n_px = cfg.width * cfg.height
    acc = torch.zeros((n_px, 3), dtype=torch.float32, device=dev)
    store = dist.FileStore(os.path.join(job["tmp"], "stop"), world)
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    setup_s = t0 - job["t_start"]
    done = [0]
    batch = world * per

    def one():
        k = done[0]
        img = render_spp_batch(scene, cam, range(f0 + k * batch, f0 + (k + 1) * batch), cfg,
                               isect, mesh)
        done[0] += 1
        return img

    stop = None
    while True:
        if stop is None:
            if rank == 0 and time.perf_counter() - t0 >= job["seconds"]:
                stop = done[0] + STOP_LAG
                if job["trace"]:
                    stop = trace_start(stop, int(traffic["trace_batches"]), f0, batch)
                store.set("stop", str(stop))
            elif rank != 0 and store.check(["stop"]):
                stop = int(store.get("stop"))
        if stop is not None and done[0] >= stop:
            break
        acc = acc + one()
    rec = None
    if job["trace"]:
        # after the untraced batches, which time the traced ones' untraced
        # cost: the profiler slows the host after it stops as well
        n_trace = int(traffic["trace_batches"])
        sync(dev)
        untraced = trace.untraced_s(n_trace, time.perf_counter() - t0, done[0])

        def traced_batches():
            nonlocal acc
            for _ in range(n_trace):
                acc = acc + one()
            return n_trace * batch
        if rank == 0:
            rec = trace.Traced(traced_batches, "sharded", lambda: sync(dev))
        else:
            traced_batches()
    sync(dev)
    wall = time.perf_counter() - t0
    peak = peak_bytes(dev)
    if rec is not None:
        rec = rec.record()
        rec.untraced_s = untraced

    n = done[0]
    pix_t = check_pixels(job["seed"], traffic, n_px, dev)
    mine = (acc[pix_t] / n).contiguous()
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    disagree = max(float((e - every[0]).abs().max()) for e in every)
    if rank != 0:
        return
    prog = every[0].cpu()
    del acc, mine, every, scene, isect, mesh
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = job["reference"].mean(spec, job["config"]["render"], pix_t,
                                list(range(f0, f0 + n * batch))).cpu()
    notes = checks.describe(prog, ref)
    notes["reference_s"] = time.perf_counter() - t_ref
    values = {"pixels_off": checks.pixels_off(prog, ref), "mean_rel": checks.mean_rel(prog, ref),
              "ranks_disagree": disagree}
    out = Outcome(end_to_end={"spp_ms": stats.per_item_ms(wall, n * batch), "setup_s": setup_s},
                  values=values, attempted=n * batch, record=rec, memory_peak_bytes=peak,
                  notes=notes)
    with open(os.path.join(job["tmp"], "outcome.pkl"), "wb") as f:
        pickle.dump(out, f)
