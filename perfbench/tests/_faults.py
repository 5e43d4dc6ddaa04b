"""Faults planted under the timed path for the fault tests: each patches the
program in the process where it runs (the test's, or a spawned rank's)."""
from __future__ import annotations

import torch


def altered_intersector(build):
    """``build`` whose closest-hit answers are altered where they are made:
    a quarter of the hits report the next face."""
    from mcrt_tpu_torch.accel import Intersector

    def make(*a, **k):
        base = build(*a, **k)

        def intersect(s, r):
            hit = base.intersect(s, r)
            lane = torch.arange(hit.prim.shape[0], device=hit.prim.device)
            alter = hit.valid & (lane % 4 == 0)
            return hit.replace(prim=torch.where(alter, hit.prim + 1, hit.prim))
        return Intersector(intersect, base.occluded, base.accel)
    return make


def half_frames(render_frame_fn):
    """A progressive frame that leaves out every other sample, the window's
    first among them (it starts at an even one), so a window of one frame
    shows it too: the film's mean is over the rest, though the frame count
    goes on."""
    def frame(scene, camera, accum, frame, cfg, intersector):
        if frame % 2 == 0:
            return accum.replace(frame=accum.frame + cfg.samples_per_pass)
        return render_frame_fn(scene, camera, accum, frame, cfg, intersector)
    return frame


def half_pixels_loss(camera, cfg, intersector, view, mesh=None):
    """``estimators.render_loss_fn`` over the first half of the image's
    pixels, the mean taken over those."""
    from mcrt_tpu_torch.parallel.render import render_spp_batch

    def loss(params, scene, frames, target):
        img = render_spp_batch(view.set(scene, params), camera, frames, cfg, intersector, mesh)
        half = img.shape[0] // 2
        return torch.mean((img[:half] - target.reshape(img.shape)[:half]) ** 2)
    return loss


def frozen_adam_step(self, closure=None):
    """``torch.optim.Adam.step`` that returns the state unchanged."""
    return None


def rank_without_exchange(rank, job):
    """A sharded rank whose collectives do nothing: each rank keeps its own
    samples' mean."""
    import torch.distributed as dist

    from perfbench.loops import sharded

    dist.all_reduce = lambda tensor, *a, **k: None
    return sharded._rank(rank, job)


def rank_with_stale_batches(rank, job):
    """A sharded rank whose ``render_spp_batch`` returns its first batch's
    image every time after: a step that returns its state unchanged."""
    from mcrt_tpu_torch.parallel import render

    from perfbench.loops import sharded

    first = {}
    base = render.render_spp_batch

    def stale(*a, **k):
        out = base(*a, **k)
        return first.setdefault("img", out)
    render.render_spp_batch = stale
    return sharded._rank(rank, job)


def rank_with_altered_hits(rank, job):
    """A sharded rank whose closest-hit answers are altered where made."""
    import mcrt_tpu_torch.accel as accel

    from perfbench.loops import sharded

    accel.build_intersector = altered_intersector(accel.build_intersector)
    return sharded._rank(rank, job)
