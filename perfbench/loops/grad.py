"""Inverse rendering: one gradient step after another in a closed loop, as
the port's ``InverseRenderer`` steps: the mean squared error of one sample
per pixel against a target rendered in set-up, the backward through every
material's albedo and roughness and every light's intensity
(``estimators.full_params``), and ``torch.optim.Adam`` with optax's
defaults.  Each step renders the next sample index.

Set-up builds the step and its optimizer once and drives them through the
first three steps, which are the ones checked; the window goes on with the
same objects.  End to end: ``peak_mem_gib`` (``max_memory_allocated`` over
the window) and ``setup_s``; the step's time is not reported, since host
noise spreads it wider than any bound the benchmark may set.  The traced
run also counts the bytes autograd saves for one step's backward
(``grad.saved_gib``).
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from .. import port, trace
from . import Outcome, first_frame, peak_bytes, sync

CHECKED_STEPS = 3
BETA1 = 0.9


def gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's.
    Leaves whose reference norm is under a thousandth of the median's are
    left out: they move by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = statistics.median(norms.values())
    gaps = [abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
            / max(norms[k], med, 1e-300)
            for k in ref if norms[k] >= 1e-3 * med]
    return max(gaps) if gaps else float("nan")


def compare(losses, first, change, ref) -> dict:
    """The compared numbers from the program's (losses, first gradient,
    parameter change) and the reference's."""
    r_losses, r_first, r_change = ref
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, r_losses)),
            "grad_gap": gap(first, r_first),
            "change_gap": gap(change, r_change)}


def control(ctx, low, steps: int = CHECKED_STEPS) -> dict:
    """The numbers a run compares, with ``low`` (the reference in a lower
    precision) in the program's place."""
    t = ctx.traffic
    f0 = first_frame(ctx.seed, t)
    args = (ctx.spec, ctx.config["render"], [f0 + i for i in range(CHECKED_STEPS)],
            int(t["target_frame"]), float(t["lr"]), ctx.device)
    ref = ctx.reference.train(*args)
    return compare(*low.train(*args), ref)


def run(ctx) -> Outcome:
    from mcrt_tpu_torch.accel import build_intersector
    from mcrt_tpu_torch.diff import estimators
    from mcrt_tpu_torch.parallel.render import render_spp_batch

    traffic, dev = ctx.traffic, ctx.device
    scene, cam = port.scene(ctx.spec, dev)
    cfg = port.render_config(ctx.config["render"])
    isect = build_intersector(scene, cfg)
    view = estimators.full_params()
    loss_fn = estimators.render_loss_fn(cam, cfg, isect, view)
    target_frame = int(traffic["target_frame"])
    with torch.no_grad():
        target = render_spp_batch(scene, cam, [target_frame], cfg, isect)
    params = {k: v.detach().clone().requires_grad_() for k, v in view.get(scene).items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    lr = float(traffic["lr"])
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(BETA1, 0.999), eps=1e-8)
    f0 = first_frame(ctx.seed, traffic)
    done = [0]

    def step():
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(params, scene, [f0 + done[0]], target)
            loss.backward()
        opt.step()
        done[0] += 1
        return loss.detach()

    # the checked steps: the step and optimizer that the window drives
    losses = [float(step())]
    first = {k: opt.state[p]["exp_avg"] / (1 - BETA1) if "exp_avg" in opt.state[p]
             else torch.zeros_like(p) for k, p in params.items()}
    losses += [float(step()) for _ in range(CHECKED_STEPS - 1)]
    change = {k: (params[k].detach() - start[k]).clone() for k in params}
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = None
    n0 = done[0]
    t0 = time.perf_counter()
    if ctx.trace:
        def traced_steps():
            for _ in range(int(traffic["trace_steps"])):
                step()
            return int(traffic["trace_steps"])
        rec = trace.Traced(traced_steps, "grad", lambda: sync(dev))
    while time.perf_counter() - t0 < ctx.seconds:
        step()
    sync(dev)
    steps = done[0] - n0
    peak = peak_bytes(dev)
    if rec is not None:
        rec = rec.record()
        rec.counters["saved_bytes"] = saved_bytes(step)

    del opt, isect, loss_fn, target, scene, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ctx.reference.train(ctx.spec, ctx.config["render"],
                              [f0 + i for i in range(CHECKED_STEPS)], target_frame, lr, dev)
    values = compare(losses, first, change, ref)
    notes = {"losses": losses, "ref_losses": ref[0],
             "reference_s": time.perf_counter() - t_ref}
    e2e = {"peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    return Outcome(end_to_end=e2e, values=values, attempted=steps, record=rec,
                   memory_peak_bytes=peak, notes=notes)


def saved_bytes(step) -> int:
    """Bytes of the storages autograd saves for the backward of one
    ``step()``, each storage counted once."""
    sizes = {}

    def pack(t):
        st = t.untyped_storage()
        sizes[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step()
    return sum(sizes.values())
