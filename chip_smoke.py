#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mcrt_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

0. Set-up: requires ``torch.cuda.is_available()``; builds the kernels
   K1-K9 from ``mcrt_tpu_torch/csrc`` with nvcc (one process per source,
   started together); prints the card's name and power limit as
   nvidia-smi reports them.
1. K8/K9, the card micro-benchmark (``mcrt_tpu_torch/tools/vpu_bench.py``)
   at its own shapes: K8's float32 and bfloat16 chains on x (256, 1024)
   must equal ``chain_plain`` bit for bit (the same single roundings); K9
   at k = 8 and 128, and at ``vpu_bench.GENERIC_KS`` (5 and 33, its
   generic path), must lie within the dot-product bound
   ``2 * k * 2**-24 * (|a| @ |b|)`` of ``matmul_plain`` elementwise (the
   share that is not bit-equal is printed).  Each kernel is timed at
   ``ITERS`` passes (median of 5) and at ``ITERS // 2``; the ratio must lie
   in [1.7, 2.3], or the compiler merged the passes.  Beside its bound each
   prints its issue floor: the instructions the work needs (K8: its rounds
   times ``ROUND_INSTRUCTIONS``, counted in the SASS; K9: an FFMA a
   multiply-add) at the FFMA issue rate ``tools/issue_rates.py`` measures
   on this card, at the SM clock ``nvidia-smi`` reads while the kernel runs
   back to back (both printed); for K8 also the time the probe's own rate
   for the whole round gives.  The plain version is timed for ``ITERS``
   calls back to back, the kernel's work.  K9's library yardstick is
   ``torch.matmul`` (TF32 off): its card time a call (queued behind a spin,
   as a kernel's, median of 5) times ``ITERS``; the old figure, ``ITERS``
   calls launched back to back by the host, is printed beside it and
   measures the host's launches, not the card.  Then ``vpu_bench.main()``
   runs with the launch counters set to 0 just before and read just after,
   and must launch K8 and K9.
2. Kernels, each against its plain PyTorch version on the card, on a
   512x512 wavefront of primary rays and one of random bounce rays, timed
   both ways, with the kernel's bound (below) printed beside its time (a
   kernel's time is the card's alone: each timed call is queued behind a
   spin on the card, so the host's time in the wrapper before the launch
   falls outside the window; ``tools/card.py: device_timed``):
   K1 cull, K2 closest hit and K3 any hit on ``sphere_field`` (~245k
   triangles); K4 and K5 (dense) on ``textured_hall``, the wavefronts
   packed as the main path packs them (unsorted: the queries sort only
   from ``SORT_MIN_BLOCKS`` = 8 blocks on); K6 and K7 (two-level) behind
   K1 over pair boxes on ``sphere_field_instanced``.  K1 keys must be
   equal; K4 closest-hit flags, slots and t equal; K5 any-hit flags equal:
   those kernels compute the plain versions' formulas without fused
   multiply-add, in the same order, and K4/K5 skip only padding slots and
   dead rays, which never hit.  The list walks K2/K3 and K6/K7 are held to a stated
   tolerance instead: their prefilter fuses its multiply-adds and defers
   the division, which can drop a grazing edge or a tie between the two
   triangles of a shared edge beyond its slack, and a warp skips list
   entries (blocks, or (instance, block) pairs) none of its rays enters,
   which differs from the plain walk only at a box's rounding edge; a hit
   they take is decided, and its t computed, by the plain arithmetic (on
   K6/K7's world rows, which are bit-equal to the plain version's).  A
   ray differs if its hit flag, slot or instance (K2, K6), or its blocked
   flag (K3, K7), differs from the plain version's, or if both hit the
   same slot (and instance) and t does not agree to rtol 1e-5; at most
   ``WALK_SHARE`` = 1e-4 of the live rays may differ, and never fewer
   than ``WALK_MIN_RAYS`` = 2 are allowed.  Every differing share, the
   largest |dt|/t, and the walks' warp visits beside their per-ray floor
   are printed.
3. Render parity: ``glass_gallery``, ``textured_hall`` and
   ``instanced_boxes`` at 64x64, 1 spp, Sobol, max_depth 3, and
   ``glass_gallery`` again under the default RANDOM sampler, once on the
   card (kernels) and once on the CPU (plain versions) with the same port
   code; at least 99% of pixels must agree to rtol 1e-3 / atol 1e-4.  Then
   one RANDOM ``next_3d`` draw of 512x512 pixels (threefry, the JAX
   package's stream) on the card must equal the CPU's bit for bit; its
   time is printed.
4. Main paths through ``Renderer`` at 512x512, 8 bounces, Sobol, SAH
   blocks, for a few progressive frames each, with the launch counters set
   to 0 just before and read just after: ``sphere_field`` (must launch
   K1-K3), ``textured_hall`` (K4/K5, and not K1-K3) and
   ``sphere_field_instanced`` (K1, K6, K7, and not K2-K5).  After the
   ``sphere_field`` frames, one more frame keeps the inputs K1 is handed
   (16 launches: 8 bounces, closest hit and shadow); each launch's keys
   must equal ``cull_plain``'s, and K1's time on each and its bound are
   summed and printed ("K1 a frame").  After the ``textured_hall`` frames,
   one more frame keeps the inputs K4 and K5 are handed (8 launches each);
   each launch's outputs must equal the plain version's, and their times
   and bounds are summed and printed ("K4/K5 a frame").  Each image must
   be finite with a positive mean, a frame run under torch's CUDA sync
   debug mode must make no synchronizing call, and the SAH builder must
   have run.  The instanced image's mean must agree with the baked
   ``sphere_field`` image's within 1%: both take the same Sobol sample
   streams over the same content, so only paths that float rounding of
   the instance transforms or the walks' fused prefilter flips can
   differ.  Each prints ms per spp,
   rays/s (closest plus shadow rays actually traced) and peak memory.
5. Slice-9 paths at the same size, each with the launch counters set to 0
   just before it is driven and read just after, and every frame under
   the sync check: ``sphere_field`` with SBVH blocks (K1-K3; its build
   time, references against triangles and blocks printed; the image
   against the SAH image of the same frames); ``render_spp_batch`` of
   ``SPP_BATCH`` samples (K1-K3; equal to the mean of the same
   ``render_sample`` calls); ``sphere_field`` with one sphere moved for
   ``ANIM_FRAMES`` frames by ``SceneAnimator.set_transform`` (made from
   ``Renderer.scene``) and ``update_scene``, ``build_blocked`` replaced by
   a raising stand-in (K1-K3; each frame's tables equal ``refit_blocked``
   of the same geometry on the CPU bit for bit, each frame agrees with a
   rebuilt ``Renderer``'s, the refit's and the transform's card times
   printed); ``sphere_field_instanced`` with one instance moved by
   ``set_shape_transform`` alike (K1, K6, K7; ``refit_two_level_scene``,
   the host builds replaced; tables equal to the CPU refit's, frames
   against rebuilds, and the moved instance's pixels changed, which fails
   if the refit left the world rows ``tw_rows`` the walks read); and
   ``texbox`` from ``tests/assets/texbox.obj`` (two textures decoded
   without an imaging library; CUDA-vs-CPU parity at 64x64 as in phase 3;
   the golden ``tests/goldens/texbox.npz`` at its own settings, 32x32, 16
   spp, max_depth 3, RANDOM, through ``AUTO`` on K4/K5, within its bound
   of 0.02 mean-relative error; then a 512x512 main-path run as in phase
   4).  Images agree at the parity share (99% of pixels within rtol 1e-3
   / atol 1e-4).
6. BDPT, through ``Renderer`` with ``IntegratorType.BDPT``,
   Sobol, SAH blocks and ``AUTO``, each path as in phase 4 (launch counters
   around it, every frame printed, the median as ms/spp, a frame under the
   sync check, a finite image with a positive mean, peak memory) and with
   the queries of a sample printed: closest-hit queries, occlusion queries
   (the chunks of at most ``MCRT_BDPT_OCC_RAYS`` = 2^21 rays) and the
   shadow rays they stage.  ``[bdpt]``: ``sphere_field`` at 512x512, depth
   8 (K1-K3 and none of K4-K7); ``[bdpt_128]``: the same at 128x128, depth
   3 (the JAX bench's BDPT configuration); ``[bdpt_dense]``:
   ``cornell_box`` at 512x512, depth 8 (K4/K5 only); ``[bdpt_instanced]``:
   ``sphere_field_instanced`` at 512x512, depth 3 (K1, K6, K7 and none of
   K2-K5).  After the timed frames of each 512x512 path, one frame more
   for each of its kernels keeps the inputs of every launch and holds each
   against the plain version, as the kernel phase holds them: K1's keys
   equal on ``[bdpt]`` and ``[bdpt_instanced]`` (pair boxes); K4/K5's
   outputs equal on ``[bdpt_dense]``; K2/K3 on ``[bdpt]`` and K6/K7 on
   ``[bdpt_instanced]`` within the walks' tolerance.  These launches
   include the light subpath's rays, which start on the light, and the
   occlusion chunks; one launch of K1, K3, K5 and K7 must be a full chunk
   of ``MCRT_BDPT_OCC_RAYS`` = 2^21 rays.  ``[bdpt_parity]``:
   ``cornell_box`` and ``glass_gallery`` at 64x64, depth 3, 1 spp, card
   against CPU at the parity share.
   ``[bdpt_converged]``: ``cornell_box`` at 32x16, 512 spp, depth 2, BDPT
   against the path tracer on the card, mean relative difference outside
   the emitter under 0.08 (``tests/test_bdpt.py``'s bound); the t=1 splats
   are float atomics (``index_add_``), so BDPT frames are compared by a
   share or a converged mean, never by equality.
7. Inverse rendering, after the ``torch.no_grad()`` block that holds
   phases 1-6, each phase with the launch counters set to 0 just before
   and read just after.  ``[grad]``: a gradient step (``make_train_step``,
   ``full_params``) on ``sphere_field`` at 512x512, depth 8, 1 spp, Sobol
   (K1-K3): the forward loss without a graph and the step timed
   ``GRAD_STEPS`` times each (median), their ratio (the JAX bench's
   ``grad_overhead_ratio``) and the peak memory printed; the gradients
   finite and those of diffuse, roughness and intensity not all zero; the
   step's loss the forward's (rtol 1e-5); then one more step holds every
   K1-K3 launch against the plain versions (K1 equal, K2/K3 within the
   walks' tolerance).  ``[grad_128]``: the same at the JAX bench's size,
   128x128, 2 spp, depth 3, ``material_params``.  ``[inverse]``:
   ``InverseRenderer`` on ``cornell_box`` (K4/K5) at 512x512, depth 8,
   ``full_params``, ``INVERSE_STEPS`` Adam steps of 1 spp from a wrong
   red-wall albedo: each step's loss (finite) and time, the peak memory;
   one more step holds every K4/K5 launch against the plain versions.
   ``[inverse_recover]``: ``tests/test_torch_inverse.py``'s albedo
   recovery on the card, at its size and criteria.  ``[grad_parity]``:
   card gradients against CPU gradients (``tools/grad_check.py``) on
   ``cornell_box`` (material and light parameters) and ``textured_hall``
   (texels), over the (sample, pixel) pairs whose forward radiance agrees
   (at least 99%), within ``grad_check.GRAD_TOL``.

A kernel's bound is the least time the card could take for the work these
inputs need: the larger of its operations over 67 TFLOP/s (H100 SXM
float32 outside the tensor cores; 133.8 TFLOP/s for K8's bfloat16 chain,
the Hopper white paper's H100 SXM5 bfloat16 rate outside the tensor cores)
and its bytes (each input read once,
each output written once) over 3.35 TB/s.  Operations: 25 a slab test,
54 a Moller-Trumbore test, 48 a slot staged into world space (K6/K7); the
tests are counted from the plain versions' loops (``cull_tests``,
``walk_tests``, ``dense_tests``: K4/K5 test only the slots that can hit,
``dense_kept``); K8 counts 5 a round of its chain and K9
2 a multiply-add, as ``tools/vpu_bench.py`` counts them.  The list walks
K2/K3 and K6/K7 have two counts, both printed, and the row takes the
smaller bound: the tile walk (``walk_tests``: every live ray of a tile
against every slot of the groups walked) and the per-ray floor
(``walk_work``: the entries of the tile's list each live ray enters no
farther than its final t, or up to its first blocking entry for K3/K7,
each a slab test and 128 Moller-Trumbore tests); K6/K7 add the slots
they stage into world space to both.  No single
PyTorch call computes a ray-triangle traversal or K8's chain, so
``library_ms`` is null for every kernel but K9 (``torch.matmul``).

The second-to-last stdout line is the per-kernel JSON record (``ms``,
``plain_ms`` and ``bound_ms`` there are the bounce wavefront's, the shape
of seven of a main path's eight bounces, K8's float32 chain's and K9's at
k = 128; ``launches`` are the counts of the main path that runs the
kernel, ``vpu_bench.main()`` for K8/K9, and ``launches_by_path`` every
phase's count of phases 4 to 7; each row's ``variants`` map holds
every wavefront's or variant's ``ms``, ``plain_ms``, ``bound_ms``,
``bound_by`` and ``library_ms``, and for K8 (float32, bfloat16) and K9
(k=8, k=128) also ``issue_floor_ms`` and ``sm_mhz``), the last one
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time
from functools import partial

WIDTH = HEIGHT = 512
MAX_DEPTH = 8
MAIN_FRAMES = 4  # timed progressive frames of each main path
KERNEL_REPS = 5  # timed calls per kernel (median reported)
PLAIN_REPS = 2
PARITY_MIN_SHARE = 0.99
INSTANCED_MEAN_RTOL = 0.01
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BF16 = 133.8e12  # H100 SXM5 bfloat16 outside the tensor cores (Hopper white paper)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
WALK_SHARE, WALK_MIN_RAYS = 1e-4, 2  # K2/K3, K6/K7: differing rays allowed (share of live, least)
ANIM_SHAPE, ANIM_FRAMES = 6, 3  # the sphere the animated phases move, and for how many frames
MIN_CHANGED = 0.002  # least share of pixels a moved sphere must change
SPP_BATCH = 4  # samples of the render_spp_batch phase
BDPT_CONVERGED_REL = 0.08  # tests/test_bdpt.py's bound, BDPT against PT at 512 spp
GRAD_STEPS = 3  # timed forward runs and gradient steps of each gradient phase (median)
INVERSE_STEPS = 4  # Adam steps of the inverse phase
HERE = os.path.dirname(os.path.abspath(__file__))
TEXBOX = os.path.join(HERE, "tests", "assets", "texbox.obj")
TEXBOX_CAMERA = dict(eye=(0.0, 1.0, 2.5), target=(0.0, 0.8, 0.0), fov_deg=50.0)
GOLDEN = os.path.join(HERE, "tests", "goldens", "texbox.npz")
GOLDEN_REL = 0.02  # the golden's own bound on the mean-relative error
OPS_SLAB, OPS_MT, OPS_STAGE = 25, 54, 48
ITERS_RATIO = (1.7, 2.3)  # time(ITERS) / time(ITERS // 2) of K8/K9
# instructions a round of K8 in the SASS of csrc/vpu.cu: FFMA, FMNMX, FADD;
# HMUL2, HADD2, HMNMX2, LOP3 (the abs), HFMA2 (the subtract)
ROUND_INSTRUCTIONS = {"float32": 3, "bfloat16": 5}
KERNELS = {  # id: (name, source, the TPU kernel it replaces)
    "K1": ("cull", "mcrt_tpu_torch/csrc/blocked.cu", "mcrt_tpu/accel/pallas_blocked.py:551"),
    "K2": ("closest", "mcrt_tpu_torch/csrc/blocked.cu", "mcrt_tpu/accel/pallas_blocked.py:733"),
    "K3": ("occluded", "mcrt_tpu_torch/csrc/blocked.cu", "mcrt_tpu/accel/pallas_blocked.py:798"),
    "K4": ("dense_closest", "mcrt_tpu_torch/csrc/dense.cu",
           "mcrt_tpu/accel/pallas_blocked.py:859"),
    "K5": ("dense_any", "mcrt_tpu_torch/csrc/dense.cu", "mcrt_tpu/accel/pallas_blocked.py:879"),
    "K6": ("closest2", "mcrt_tpu_torch/csrc/two_level.cu", "mcrt_tpu/accel/two_level.py:423"),
    "K7": ("occluded2", "mcrt_tpu_torch/csrc/two_level.cu", "mcrt_tpu/accel/two_level.py:491"),
    "K8": ("vpu_chain", "mcrt_tpu_torch/csrc/vpu.cu", "tools/vpu_bench.py:16"),
    "K9": ("vpu_matmul", "mcrt_tpu_torch/csrc/vpu.cu", "tools/vpu_bench.py:38"),
}


def log(msg: str):
    print(msg, flush=True)


def timed(fn, reps: int):
    """Median milliseconds of ``reps`` calls, each bracketed by
    ``torch.cuda.synchronize()`` and timed with CUDA events; returns
    (median_ms, every call's ms, last result)."""
    import torch

    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times, out


def host_queue_ms(fn, reps: int) -> float:
    """Median milliseconds the host takes to queue one call of ``fn`` (no
    synchronisation inside the window): where it is longer than the call's
    card time, the card waits for the host."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def kernel_timed(fn, reps: int):
    """As ``timed``, for a kernel: its time on the card alone, the host's
    time in the wrapper excluded (``tools/card.py: device_timed``)."""
    from mcrt_tpu_torch.tools.card import device_timed

    return device_timed(fn, reps)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: int, moved: int, peak: float = PEAK_FLOPS):
    """(bound ms, "operations" or "bytes")."""
    ops_ms, bytes_ms = ops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class KernelResults:
    """Per kernel: each wavefront's (or variant's) times and bound, and the
    largest error against the plain version."""

    def __init__(self):
        self.rows = {k: {"ms": [], "plain_ms": [], "bound": [], "max_abs_err": 0.0,
                         "library_ms": None, "variants": {}} for k in KERNELS}

    def record(self, k, wf, ms, plain_ms, err, ops, moved, peak=PEAK_FLOPS, library_ms=None,
               floor_ops=None, issue=None):
        """``floor_ops``: a second count of the work (the list walks'
        per-ray floor); both bounds are printed and the smaller is kept.
        ``issue``: (issue floor ms, sampled SM clock MHz), printed beside
        the bound (K8/K9)."""
        r = self.rows[k]
        b_ms, by = bound(ops, moved, peak)
        if floor_ops is not None:
            f_ms, f_by = bound(floor_ops, moved, peak)
            log(f"[kernels:{wf}] {k} bounds: tile walk {b_ms:.4f} ms by {by} "
                f"({ops:.4e} operations), per-ray floor {f_ms:.4f} ms by {f_by} "
                f"({floor_ops:.4e} operations); the smaller is used")
            if f_ms < b_ms:
                b_ms, by, ops = f_ms, f_by, floor_ops
        r["library_ms"] = library_ms
        r["ms"].append(ms)
        r["plain_ms"].append(plain_ms)
        r["bound"].append((b_ms, by))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["variants"][wf] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                             "library_ms": library_ms}
        extra = ""
        if issue is not None:
            r["variants"][wf].update(issue_floor_ms=issue[0], sm_mhz=issue[1])
            extra = f", issue floor {issue[0]:.4f} ms at {issue[1]:.0f} MHz SM clock"
        log(f"[kernels:{wf}] {k} {KERNELS[k][0]} {ms:.3f} ms (plain {plain_ms:.3f} ms), "
            f"bound {b_ms:.4f} ms by {by} ({ops:.4e} operations, {moved} bytes){extra}")


def check_closest(k, wf, kern, plain):
    """Closest-hit outputs (t, slot) of a kernel and its plain version:
    slots and t equal (misses included: t = BIG, slot = -1)."""
    (t_k, s_k), (t_p, s_p) = kern, plain
    hk, hp = s_k >= 0, s_p >= 0
    both = hk & hp
    bad = (s_k != s_p) | (t_k != t_p)
    share = bad.float().mean().item()
    err = (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0
    log(f"[kernels:{wf}] {k}: {int(hk.sum())} hits, differing share {share:.2e}, "
        f"max |dt| {err:.3e}")
    if bad.any():
        raise AssertionError(f"{k} differs from the plain version ({wf}): share {share:.2e}")
    return err


def walk_allowed(live) -> int:
    """Rays of a wavefront on which a list walk (K2/K3, K6/K7) may differ
    from its plain version."""
    return max(WALK_MIN_RAYS, int(WALK_SHARE * int(live.sum())))


def check_walk_closest(k, wf, kern, plain, live):
    """A closest-hit walk, K2 (t, slot) or K6 (t, slot, instance), against
    its plain version within the stated tolerance; returns the largest |dt|
    where both hit."""
    import torch

    (t_k, s_k, *i_k), (t_p, s_p, *i_p) = kern, plain
    hk, hp = s_k >= 0, s_p >= 0
    both = hk & hp
    inst_off = both & (i_k[0] != i_p[0]) if i_k else torch.zeros_like(both)
    same = both & (s_k == s_p) & ~inst_off
    t_off = same & ~torch.isclose(t_k, t_p, rtol=1e-5, atol=0.0)
    bad = (hk != hp) | (s_k != s_p) | inst_off | t_off
    n_bad, allowed, n_live = int(bad.sum()), walk_allowed(live), int(live.sum())
    err = (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0
    rel = ((t_k[same] - t_p[same]).abs() / t_p[same]).max().item() if same.any() else 0.0
    log(f"[kernels:{wf}] {k}: {int(hk.sum())} hits (plain {int(hp.sum())}); differing rays "
        f"{n_bad} of {n_live} live, share {n_bad / max(n_live, 1):.2e} (flag "
        f"{int((hk != hp).sum())}, slot {int((both & (s_k != s_p)).sum())}, instance "
        f"{int(inst_off.sum())}, t {int(t_off.sum())}; allowed {allowed}); max |dt|/t "
        f"{rel:.3e} on the same slot, max |dt| {err:.3e}")
    if n_bad > allowed:
        raise AssertionError(f"{k} differs from the plain version ({wf}) on {n_bad} rays, "
                             f"more than the {allowed} allowed")
    return err


def check_walk_any(k, wf, b_k, b_p, live):
    """An any-hit walk (K3, K7) against its plain version within the stated
    tolerance."""
    bad = b_k != b_p
    n_bad, allowed, n_live = int(bad.sum()), walk_allowed(live), int(live.sum())
    log(f"[kernels:{wf}] {k}: {int(b_k.sum())} blocked (plain {int(b_p.sum())}); differing "
        f"rays {n_bad} of {n_live} live, share {n_bad / max(n_live, 1):.2e} (blocked only by "
        f"the kernel {int((bad & (b_k > 0)).sum())}, only by the plain version "
        f"{int((bad & (b_p > 0)).sum())}; allowed {allowed})")
    if n_bad > allowed:
        raise AssertionError(f"{k} differs from the plain version ({wf}) on {n_bad} rays, "
                             f"more than the {allowed} allowed")
    return (b_k - b_p).abs().max().item()


def log_walk_work(k, wf, tests, least, warp, entry):
    """The tile walk's tests, the kernel's warp visits and the per-ray
    floor, in Moller-Trumbore tests; ``entry`` names a list entry ("block"
    or "pair")."""
    log(f"[kernels:{wf}] {k} work: tile walk {tests:.4e} tests; kernel {warp} warp-{entry} "
        f"visits ({warp * 32 * 128:.4e} tests); per-ray floor {least} ray-{entry} visits "
        f"({least * 128:.4e} tests); warp visits / floor {warp * 32 / max(least, 1):.3f}")


def check_any(k, wf, b_k, b_p):
    share = (b_k != b_p).float().mean().item()
    log(f"[kernels:{wf}] {k}: {int(b_k.sum())} blocked, differing share {share:.2e}")
    if not bool((b_k == b_p).all()):
        raise AssertionError(f"{k} differs from the plain version ({wf}): share {share:.2e}")
    return (b_k - b_p).abs().max().item()


def cull_and_check(res, wf, packed, chunk, boxes, k_id="K1"):
    """K1 against its plain version; returns the visit lists."""
    import torch

    from mcrt_tpu_torch.accel import blocked, kernels

    tile = blocked.TILE
    ms, _, keys = kernel_timed(lambda: kernels.cull(packed, chunk, boxes, tile), KERNEL_REPS)
    pms, _, keys_p = timed(lambda: blocked.cull_plain(packed, chunk, boxes, tile), PLAIN_REPS)
    if not torch.equal(keys, keys_p):
        bad = (keys != keys_p).float().mean().item()
        raise AssertionError(f"K1 keys differ from the plain version ({wf}): share {bad}")
    entered = keys < 0.5 * blocked.BIG
    err = (keys[entered] - keys_p[entered]).abs().max().item() if entered.any() else 0.0
    ops = blocked.cull_tests(packed, chunk, boxes, tile) * OPS_SLAB
    if k_id:
        res.record(k_id, wf, ms, pms, err, ops, nbytes(packed, chunk, boxes, keys))
    else:
        log(f"[kernels:{wf}] K1 over pair boxes {ms:.3f} ms (plain {pms:.3f} ms), keys equal")
    counts, lists, tn_sorted = blocked.lists_from_keys(keys)
    log(f"[kernels:{wf}] {int((packed[7] > packed[6]).sum())} live rays, "
        f"{int(counts.sum())} visits over {counts.numel()} tiles")
    return counts, lists, tn_sorted


def vpu_kernels(res, device):
    """K8/K9 against their plain versions, timed at ITERS and ITERS // 2,
    each beside its bound and its issue floor at the SM clock sampled while
    it runs; then ``vpu_bench.main()``, the path that runs them, with the
    launch counters set to 0 just before; returns its launch counts."""
    import torch

    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.tools import issue_rates
    from mcrt_tpu_torch.tools import vpu_bench as vb
    from mcrt_tpu_torch.tools.card import sm_clock_during

    rates = issue_rates.measure()
    sms, probes = rates["sms"], rates["probes"]
    for name, p in probes.items():
        log(f"[vpu] issue rate {name}: {p['lanes_per_clk_sm']:.2f} lanes/clk/SM "
            f"({p['ops']} ops an apply, {p['warps_per_sm']} warps/SM), latency "
            f"{p['latency_clk']:.2f} clk, SM clock {p['mhz']:.0f} MHz")

    def issue_floor(fn, ms, instructions):
        """(floor ms, sampled MHz): ``instructions`` lane-instructions at
        the FFMA probe's measured issue rate (about one warp instruction a
        clock per scheduler) on every SM, at the SM clock sampled while
        ``fn`` runs."""
        mhz, _ = sm_clock_during(fn, ms)
        return issue_rates.floor_ms(instructions, probes["ffma"], sms, mhz), mhz

    def iters_ratio(k, label, full_ms, half_ms):
        ratio = full_ms / half_ms
        log(f"[vpu] {k} {label}: {full_ms:.3f} ms at {vb.ITERS} passes, {half_ms:.3f} ms at "
            f"{vb.ITERS // 2}, ratio {ratio:.3f} (must lie in {list(ITERS_RATIO)})")
        if not ITERS_RATIO[0] <= ratio <= ITERS_RATIO[1]:
            raise AssertionError(f"{k} {label}: time does not follow the pass count "
                                 f"(ratio {ratio:.3f}): were the passes merged?")

    def repeated(fn):
        """``fn`` called ``ITERS`` times back to back; returns the last result."""
        def run():
            for _ in range(vb.ITERS):
                out = fn()
            return out
        return run

    x = vb.chain_input(device)
    # the float32 chain is recorded last: the row's top level carries the last record
    for dtype, peak, probe in ((torch.bfloat16, PEAK_BF16, "round_bf16"),
                               (torch.float32, PEAK_FLOPS, "round_f32")):
        label = str(dtype).split(".")[-1]
        ms, _, out = kernel_timed(lambda: vb.run_chain(x, dtype), KERNEL_REPS)
        half, _, _ = kernel_timed(lambda: vb.run_chain(x, dtype, vb.ITERS // 2), KERNEL_REPS)
        iters_ratio("K8", label, ms, half)
        lanes = x.numel() // (2 if dtype == torch.bfloat16 else 1)  # bfloat16: packed pairs
        rounds = vb.ITERS * vb.ROUNDS * lanes
        issue = issue_floor(lambda: vb.run_chain(x, dtype), ms, rounds * ROUND_INSTRUCTIONS[label])
        log(f"[vpu] K8 {label}: {ROUND_INSTRUCTIONS[label]} instructions a round; the probe's "
            f"rate for the round alone ({probe}, 8 independent chains a thread) gives "
            f"{issue_rates.floor_ms(rounds, probes[probe], sms, issue[1]):.4f} ms")
        vb.chain_plain(x, dtype)  # warm-up
        pms, _, plain = timed(repeated(lambda: vb.chain_plain(x, dtype)), 1)
        view = torch.int32 if dtype == torch.float32 else torch.int16
        share = (out.view(view) != plain.view(view)).float().mean().item()
        err = (out.float() - plain.float()).abs().max().item()
        log(f"[vpu] K8 {label}: differing share {share:.2e}, max |diff| {err:.3e}, "
            f"|out| up to {out.float().abs().max().item():.4e}; plain x{vb.ITERS} back to back "
            f"{pms:.3f} ms")
        if share or not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"K8 {label} differs from chain_plain: share {share:.2e}")
        ops = vb.ITERS * vb.ROUNDS * 5 * x.numel()
        res.record("K8", label, ms, pms, err, ops, 2 * nbytes(out), peak, issue=issue)
        log(f"[vpu] K8 {label}: {ops / (ms / 1e3) / 1e12:.3f} Tops/s sustained")
    for k in vb.KS + vb.GENERIC_KS:
        a, b = vb.matmul_inputs(device, k)
        ms, _, out = kernel_timed(lambda: vb.run_matmul(a, b), KERNEL_REPS)
        half, _, _ = kernel_timed(lambda: vb.run_matmul(a, b, vb.ITERS // 2), KERNEL_REPS)
        iters_ratio("K9", f"k={k}", ms, half)
        fl = vb.ITERS * 2 * a.shape[0] * k * b.shape[1]
        issue = issue_floor(lambda: vb.run_matmul(a, b), ms, fl // 2)  # an FFMA a multiply-add
        plain = vb.matmul_plain(a, b)
        tol = 2 * k * 2.0**-24 * (a.double().abs() @ b.double().abs())
        diff = (out.double() - plain.double()).abs()
        share = (out.view(torch.int32) != plain.view(torch.int32)).float().mean().item()
        err = diff.max().item()
        log(f"[vpu] K9 k={k}: max |diff| {err:.3e} (dot bound up to {tol.max().item():.3e}), "
            f"not bit-equal share {share:.2e}")
        if not bool((diff <= tol).all()):
            raise AssertionError(f"K9 k={k} leaves the dot-product bound of matmul_plain")
        if k not in vb.KS:  # the generic path: checked and timed, not a row of its own
            log(f"[vpu] K9 k={k} (generic path): {ms:.3f} ms, issue floor {issue[0]:.4f} ms "
                f"at {issue[1]:.0f} MHz SM clock")
            continue
        pms, _, _ = timed(repeated(lambda: vb.matmul_plain(a, b)), 1)
        torch.matmul(a, b)  # warm-up
        lib_call, _, _ = kernel_timed(lambda: torch.matmul(a, b), KERNEL_REPS)
        lib_ms = lib_call * vb.ITERS
        host_ms, _, _ = timed(repeated(lambda: torch.matmul(a, b)), 1)
        log(f"[vpu] K9 k={k}: plain x{vb.ITERS} back to back {pms:.3f} ms; torch.matmul card "
            f"time {lib_call:.4f} ms a call (median of {KERNEL_REPS}), x{vb.ITERS} = "
            f"{lib_ms:.3f} ms; [host-launched: x{vb.ITERS} back to back {host_ms:.3f} ms, "
            f"the host's launch time]; the kernel is "
            f"{'slower' if ms > lib_ms else 'faster'} than torch.matmul")
        res.record("K9", f"k={k}", ms, pms, err, fl, nbytes(a, b, out), library_ms=lib_ms,
                   issue=issue)
        log(f"[vpu] K9 k={k}: {fl / (ms / 1e3) / 1e12:.3f} TF/s sustained "
            f"(torch.matmul {fl / (lib_ms / 1e3) / 1e12:.3f} TF/s on the card)")

    kernels.reset_launch_counts()
    rc = vb.main([])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[vpu] vpu_bench.main() returned {rc}, launches {counts}")
    if rc != 0:
        raise AssertionError(f"vpu_bench.main() returned {rc}")
    missing = [k for k in ("K8", "K9") if counts[k] == 0]
    if missing:
        raise AssertionError(f"vpu_bench.main() did not launch {missing}")
    return counts


def visit_list_kernels(res, device):
    """K1-K3 on the visit-list path's scene."""
    from mcrt_tpu_torch.accel import blocked, kernels
    from mcrt_tpu_torch.accel.blocked import build_blocked, intersect_blocked
    from mcrt_tpu_torch.scene.builders import sphere_field
    from mcrt_tpu_torch.tools.wavefronts import wavefronts

    t0 = time.perf_counter()
    scene, camera = sphere_field(device=device)
    accel = build_blocked(scene.geometry)
    log(f"[scene] sphere_field: {int(scene.geometry.face_valid.sum())} triangles, "
        f"{accel.num_blocks} blocks, builder {accel.builder}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    tile, group = blocked.TILE, blocked.GROUP
    tri, boxes = accel.tri, accel.aabb
    rows, entry_boxes = blocked.flat_rows(tri), blocked.block_boxes(tri, boxes)
    visit = OPS_SLAB + blocked.BLOCK * OPS_MT  # a block a ray enters, in the per-ray floor
    waves = wavefronts(camera, lambda r: intersect_blocked(scene.geometry, accel, r), device)
    for wf, rays in waves.items():
        packed, _ = blocked._sorted_table(rays, accel, True)
        live = packed[7] > packed[6]
        counts, lists, tn = cull_and_check(res, wf, packed, accel.chunk_aabb, boxes)
        ms, _, out_k = kernel_timed(lambda: kernels.closest(counts, packed, lists, tn, tri,
                                                            boxes, tile, group), KERNEL_REPS)
        pms, _, out_p = timed(lambda: blocked.closest_plain(counts, packed, lists, tn, tri,
                                                            tile, group), PLAIN_REPS)
        err = check_walk_closest("K2", wf, out_k, out_p, live)
        tests, _ = blocked.walk_tests(counts, packed, lists, tn, rows, tile, group, True)
        least, warp = blocked.walk_work(counts, packed, lists, tn, rows, entry_boxes, tile,
                                        group, True)
        log_walk_work("K2", wf, tests, least, warp, "block")
        res.record("K2", wf, ms, pms, err, tests * OPS_MT,
                   nbytes(counts, packed, lists, tn, tri, boxes, *out_k), floor_ops=least * visit)
        ms, _, b_k = kernel_timed(lambda: kernels.occluded(counts, packed, lists, tri, boxes,
                                                           tile, group), KERNEL_REPS)
        pms, _, b_p = timed(lambda: blocked.occluded_plain(counts, packed, lists, tri,
                                                           tile, group), PLAIN_REPS)
        err = check_walk_any("K3", wf, b_k, b_p, live)
        tests, _ = blocked.walk_tests(counts, packed, lists, None, rows, tile, group, False)
        least, warp = blocked.walk_work(counts, packed, lists, tn, rows, entry_boxes, tile,
                                        group, False)
        log_walk_work("K3", wf, tests, least, warp, "block")
        res.record("K3", wf, ms, pms, err, tests * OPS_MT,
                   nbytes(counts, packed, lists, tri, boxes, b_k), floor_ops=least * visit)
    return scene, camera


def dense_kernels(res, device):
    """K4/K5 on the dense path's scene."""
    from mcrt_tpu_torch.accel import SORT_MIN_BLOCKS, blocked, kernels
    from mcrt_tpu_torch.accel.blocked import build_blocked, intersect_blocked
    from mcrt_tpu_torch.scene.builders import textured_hall
    from mcrt_tpu_torch.tools.wavefronts import wavefronts

    scene, camera = textured_hall(device=device)
    accel = build_blocked(scene.geometry)
    log(f"[scene] textured_hall: {int(scene.geometry.face_valid.sum())} triangles, "
        f"{accel.num_blocks} blocks ({accel.num_slots} slots), {scene.textures.num} textures")
    if accel.num_blocks > blocked.DENSE_BLOCKS:
        raise AssertionError("textured_hall does not take the dense path")
    tri = accel.tri
    waves = wavefronts(camera, lambda r: intersect_blocked(scene.geometry, accel, r), device)
    log(f"[scene] textured_hall: K4/K5 keep {int(blocked.dense_kept(tri).sum())} of "
        f"{tri.shape[1]} slots")
    for wf, rays in waves.items():
        # packed as the main path packs them: unsorted below SORT_MIN_BLOCKS
        packed, _ = blocked._sorted_table(rays, accel, accel.num_blocks >= SORT_MIN_BLOCKS)
        ms, _, out_k = kernel_timed(lambda: kernels.dense_closest(packed, tri), KERNEL_REPS)
        pms, _, out_p = timed(lambda: blocked.dense_closest_plain(packed, tri), PLAIN_REPS)
        err = check_closest("K4", wf, out_k, out_p)
        res.record("K4", wf, ms, pms, err, blocked.dense_tests(packed, tri, True) * OPS_MT,
                   nbytes(packed, tri, *out_k))
        ms, _, b_k = kernel_timed(lambda: kernels.dense_any(packed, tri), KERNEL_REPS)
        pms, _, b_p = timed(lambda: blocked.dense_any_plain(packed, tri), PLAIN_REPS)
        err = check_any("K5", wf, b_k, b_p)
        res.record("K5", wf, ms, pms, err, blocked.dense_tests(packed, tri, False) * OPS_MT,
                   nbytes(packed, tri, b_k))


def two_level_kernels(res, device):
    """K6/K7 (behind K1 over the pair boxes) on the instanced scene."""
    from mcrt_tpu_torch.accel import blocked, kernels
    from mcrt_tpu_torch.accel import two_level as tl
    from mcrt_tpu_torch.scene.builders import sphere_field_instanced
    from mcrt_tpu_torch.tools.wavefronts import wavefronts

    t0 = time.perf_counter()
    scene, camera = sphere_field_instanced(device=device)
    accel = tl.build_two_level_scene(scene.geometry, scene.shapes.to_world, scene.instances)
    log(f"[scene] sphere_field_instanced: {int(scene.geometry.face_valid.sum())} source "
        f"triangles, {scene.instances.num} instances, {accel.num_instances} two-level "
        f"instances, {accel.blas.num_blocks} BLAS blocks, {accel.num_pairs} pairs, built in "
        f"{time.perf_counter() - t0:.2f} s")
    tile, group = blocked.TILE, blocked.GROUP
    args = (accel.blas.tri, accel.pair_code, accel.tw_rows)
    boxes = accel.pair_aabb
    rows = tl.pair_rows(*args)
    visit = OPS_SLAB + blocked.BLOCK * OPS_MT  # a pair a ray enters, in the per-ray floor
    waves = wavefronts(camera, lambda r: tl.intersect_two_level(scene.geometry, accel, r),
                       device)
    for wf, rays in waves.items():
        packed, _ = blocked._sorted_table(rays, accel, True)
        live = packed[7] > packed[6]
        counts, lists, tn = cull_and_check(res, wf, packed, accel.pair_chunk, boxes, k_id=None)
        ms, _, out_k = kernel_timed(lambda: kernels.closest2(counts, packed, lists, tn, *args,
                                                             boxes, tile, group), KERNEL_REPS)
        pms, _, out_p = timed(lambda: tl.closest2_plain(counts, packed, lists, tn, *args, tile,
                                                        group), PLAIN_REPS)
        err = check_walk_closest("K6", wf, out_k, out_p, live)
        tests, staged = blocked.walk_tests(counts, packed, lists, tn, rows, tile, group, True)
        least, warp = blocked.walk_work(counts, packed, lists, tn, rows, boxes, tile, group,
                                        True)
        log_walk_work("K6", wf, tests, least, warp, "pair")
        res.record("K6", wf, ms, pms, err, tests * OPS_MT + staged * OPS_STAGE,
                   nbytes(counts, packed, lists, tn, *args, boxes, *out_k),
                   floor_ops=least * visit + staged * OPS_STAGE)
        ms, _, b_k = kernel_timed(lambda: kernels.occluded2(counts, packed, lists, *args, boxes,
                                                            tile, group), KERNEL_REPS)
        pms, _, b_p = timed(lambda: tl.occluded2_plain(counts, packed, lists, *args, tile,
                                                       group), PLAIN_REPS)
        err = check_walk_any("K7", wf, b_k, b_p, live)
        tests, staged = blocked.walk_tests(counts, packed, lists, None, rows, tile, group, False)
        least, warp = blocked.walk_work(counts, packed, lists, tn, rows, boxes, tile, group,
                                        False)
        log_walk_work("K7", wf, tests, least, warp, "pair")
        res.record("K7", wf, ms, pms, err, tests * OPS_MT + staged * OPS_STAGE,
                   nbytes(counts, packed, lists, *args, boxes, b_k),
                   floor_ops=least * visit + staged * OPS_STAGE)


def parity_phase(name: str, sampler: str = "SOBOL", integrator: str = "PATH"):
    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.config import (IntegratorConfig, IntegratorType, RenderConfig,
                                       SamplerConfig, SamplerType)
    from mcrt_tpu_torch.scene import builders

    cfg = RenderConfig(width=64, height=64, spp=1,
                       sampler=SamplerConfig(type=SamplerType[sampler]),
                       integrator=IntegratorConfig(type=IntegratorType[integrator], max_depth=3))
    label = f"{name} ({sampler.lower()})"
    tag = "bdpt_parity" if integrator == "BDPT" else "parity"
    images = {}
    for dev in ("cuda", "cpu"):
        scene, camera = getattr(builders, name)(device=dev)
        t0 = time.perf_counter()
        images[dev] = Renderer(scene, camera, cfg, device=dev).render().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"[{tag}] {label} 64x64 on {dev}: {time.perf_counter() - t0:.2f} s")
    close = torch.isclose(images["cuda"], images["cpu"], rtol=1e-3, atol=1e-4).all(dim=-1)
    share = close.float().mean().item()
    log(f"[{tag}] {label}: pixels agreeing (rtol 1e-3, atol 1e-4): {share:.4f} "
        f"(mismatch {1 - share:.4f}); means {images['cuda'].mean():.5f} / "
        f"{images['cpu'].mean():.5f}")
    if share < PARITY_MIN_SHARE:
        raise AssertionError(f"{label}: CUDA-vs-CPU render parity {share:.4f} < "
                             f"{PARITY_MIN_SHARE}")
    return share


def random_draw_phase(device):
    """One RANDOM ``next_3d`` draw of a 512x512 wavefront (threefry, the
    JAX package's stream) on the card: bit-equal to the same draw on the
    CPU; its time is printed (median of ``KERNEL_REPS``)."""
    import torch

    from mcrt_tpu_torch.config import SamplerConfig
    from mcrt_tpu_torch.sampling import rng

    pixels = torch.arange(WIDTH * HEIGHT, dtype=torch.int32)
    streams = {dev: rng.make_stream(SamplerConfig(seed=7), 3, pixels.to(dev)).advance(11)
               for dev in (device, "cpu")}
    ms, _, u = timed(lambda: rng.next_3d(streams[device])[0], KERNEL_REPS)
    ref, _ = rng.next_3d(streams["cpu"])
    equal = torch.equal(u.cpu().view(torch.int32), ref.view(torch.int32))
    log(f"[random] next_3d of {WIDTH * HEIGHT} pixels on the card: {ms:.3f} ms (median of "
        f"{KERNEL_REPS}), bit-equal to the CPU draw: {equal}")
    if not equal:
        raise AssertionError("the RANDOM draw on the card differs from the CPU draw")


def check_full_chunk(label, k, launches):
    """Raises unless one of ``k``'s launches in a frame (their ray tables'
    widths, ``launches``) was a full BDPT occlusion chunk of
    ``bdpt.OCC_CHUNK_RAYS`` rays: a BDPT path's frame phase holds the kernel
    against its plain version at that size."""
    from mcrt_tpu_torch.integrators import bdpt

    largest = max(launches, default=0)
    log(f"[{label}] {k}: the largest launch of the frame holds {largest} rays "
        f"(a full occlusion chunk is {bdpt.OCC_CHUNK_RAYS})")
    if largest < bdpt.OCC_CHUNK_RAYS:
        raise AssertionError(f"{label}: no launch of {k} in the frame was a full occlusion "
                             "chunk")


def cull_frame_phase(frame, label, chunk=False):
    """The inputs K1 is handed during one call of ``frame`` (a frame, or a
    gradient step): each launch's keys equal to the plain version's; K1's
    time on each (median of ``KERNEL_REPS``) and its bound, summed over the
    call.  With ``chunk``, one launch must have been a full occlusion
    chunk."""
    import torch

    from mcrt_tpu_torch.accel import blocked, kernels
    from mcrt_tpu_torch.tools.wavefronts import inputs_of

    inputs = inputs_of(frame, ["K1"])["K1"]
    total_ms = total_bound = 0.0
    for packed, chunk_aabb, boxes, tile in inputs:
        ms, _, keys = kernel_timed(lambda: kernels.cull(packed, chunk_aabb, boxes, tile),
                                   KERNEL_REPS)
        if not torch.equal(keys, blocked.cull_plain(packed, chunk_aabb, boxes, tile)):
            raise AssertionError(f"{label}: K1 keys of a frame's launch differ from the "
                                 "plain version")
        b_ms, _ = bound(blocked.cull_tests(packed, chunk_aabb, boxes, tile) * OPS_SLAB,
                        nbytes(packed, chunk_aabb, boxes, keys))
        total_ms += ms
        total_bound += b_ms
    log(f"[{label}] K1 a frame: {total_ms:.4f} ms, bound {total_bound:.4f} ms, "
        f"{len(inputs)} launches (keys equal to the plain version's on each)")
    if chunk:
        check_full_chunk(label, "K1", [a[0].shape[1] for a in inputs])


def dense_frame_phase(frame, label, chunk=False):
    """The inputs K4 and K5 are handed during one call of ``frame`` (a
    frame, or a gradient step): each launch's outputs equal to the plain
    version's (as in the kernel phase); the kernels' time on each (median
    of ``KERNEL_REPS``) and their bound, summed over the call's launches of
    both.  With ``chunk``, one launch of K5 must have been a full occlusion
    chunk."""
    from mcrt_tpu_torch.accel import blocked, kernels
    from mcrt_tpu_torch.tools.wavefronts import inputs_of

    inputs = inputs_of(frame, ["K4", "K5"])
    total_ms = total_bound = 0.0
    for k, (kern, plain, closest) in {
            "K4": (kernels.dense_closest, blocked.dense_closest_plain, True),
            "K5": (kernels.dense_any, blocked.dense_any_plain, False)}.items():
        for i, (packed, tri) in enumerate(inputs[k]):
            ms, _, out = kernel_timed(lambda: kern(packed, tri), KERNEL_REPS)
            ref = plain(packed, tri)
            wf = f"{label} frame launch {i}"
            if closest:
                check_closest(k, wf, out, ref)
                moved = nbytes(packed, tri, *out)
            else:
                check_any(k, wf, out, ref)
                moved = nbytes(packed, tri, out)
            b_ms, _ = bound(blocked.dense_tests(packed, tri, closest) * OPS_MT, moved)
            log(f"[{label}] {k} frame launch {i}: {int((packed[7] > packed[6]).sum())} live "
                f"rays, {ms:.4f} ms, bound {b_ms:.4f} ms")
            total_ms += ms
            total_bound += b_ms
    n = len(inputs["K4"]) + len(inputs["K5"])
    log(f"[{label}] K4/K5 a frame: {total_ms:.4f} ms, bound {total_bound:.4f} ms, {n} launches "
        f"(K4 {len(inputs['K4'])}, K5 {len(inputs['K5'])}; each equal to the plain version)")
    if not inputs["K4"] or not inputs["K5"]:
        raise AssertionError(f"{label}: a frame launched no K4 or no K5")
    if chunk:
        check_full_chunk(label, "K5", [a[0].shape[1] for a in inputs["K5"]])


def walk_frame_phase(frame, label, ids, chunk=None):
    """The inputs the list walks ``ids`` (K2/K3, or K6/K7) are handed
    during one call of ``frame`` (a frame, or a gradient step): each launch
    against its plain version within the walks' tolerance (``WALK_SHARE``,
    ``WALK_MIN_RAYS``); the kernels' time on each (median of
    ``KERNEL_REPS``), summed over the call.  Where ``chunk`` names a
    kernel, one of its launches must have been a full occlusion chunk."""
    from mcrt_tpu_torch.accel import blocked, kernels
    from mcrt_tpu_torch.accel import two_level as tl
    from mcrt_tpu_torch.tools.wavefronts import inputs_of

    # the plain versions take the kernel's arguments without its entry
    # boxes, the third from last
    plain = {"K2": blocked.closest_plain, "K3": blocked.occluded_plain,
             "K6": tl.closest2_plain, "K7": tl.occluded2_plain}
    inputs = inputs_of(frame, ids)
    for k in ids:
        total_ms = 0.0
        for i, args in enumerate(inputs[k]):
            packed = args[1]
            live = packed[7] > packed[6]
            ms, _, out = kernel_timed(lambda: kernels.WRAPPERS[k](*args), KERNEL_REPS)
            ref = plain[k](*args[:-3], *args[-2:])
            wf = f"{label} frame launch {i}, {packed.shape[1]} rays"
            if k in ("K2", "K6"):
                check_walk_closest(k, wf, out, ref, live)
            else:
                check_walk_any(k, wf, out, ref, live)
            total_ms += ms
        log(f"[{label}] {k} a frame: {total_ms:.4f} ms, {len(inputs[k])} launches (each "
            "within the walks' tolerance of the plain version)")
        if not inputs[k]:
            raise AssertionError(f"{label}: a frame launched no {k}")
    if chunk:
        check_full_chunk(label, chunk, [a[1].shape[1] for a in inputs[chunk]])


def main_cfg(builder="SAH", spp=MAIN_FRAMES + 3, integrator="PATH", size=WIDTH,
             depth=MAX_DEPTH):
    """The main paths' configuration: 512x512, 8 bounces, Sobol (the BDPT
    phases change the integrator, and some the size or depth)."""
    from mcrt_tpu_torch.config import (BuilderType, BVHConfig, IntegratorConfig,
                                       IntegratorType, RenderConfig, SamplerConfig,
                                       SamplerType)

    return RenderConfig(width=size, height=size, spp=spp,
                        sampler=SamplerConfig(type=SamplerType.SOBOL),
                        bvh=BVHConfig(builder=BuilderType[builder]),
                        integrator=IntegratorConfig(type=IntegratorType[integrator],
                                                    max_depth=depth))


def check_launches(label, counts, expect, forbid):
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched on the main path: {missing}")
    stray = [k for k in forbid if counts[k]]
    if stray:
        raise AssertionError(f"{label}: kernels of another path launched: {stray}")


def check_no_sync(label, sites):
    log(f"[{label}] synchronizing calls in one frame: {sum(sites.values())} "
        + ", ".join(f"{site} x{n}" for site, n in sites.most_common()))
    if sites:
        raise AssertionError(f"{label}: the frame waits for the card at {dict(sites)}")


def agreement(label, what, a, b, min_share=PARITY_MIN_SHARE):
    """Share of pixels of images ``a`` and ``b`` within rtol 1e-3 / atol
    1e-4; raises below ``min_share``."""
    import torch

    share = torch.isclose(a, b, rtol=1e-3, atol=1e-4).all(dim=-1).float().mean().item()
    log(f"[{label}] {what}: pixels agreeing (rtol 1e-3, atol 1e-4): {share:.4f}; means "
        f"{a.mean().item():.5f} / {b.mean().item():.5f}")
    if share < min_share:
        raise AssertionError(f"{label}: {what}: agreement {share:.4f} < {min_share}")
    return share


def main_path_phase(label, scene, camera, device, expect, forbid, frame_phases=(),
                    cfg=None):
    """``Renderer`` on ``scene`` under ``cfg`` (``main_cfg()`` by default):
    returns (launch counts, ms/spp, rays/s, image mean, image after the
    timed frames); then each of ``frame_phases(frame, label)``, each on one
    more frame, ``frame()`` running it."""
    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import Intersector, kernels
    from mcrt_tpu_torch.tools.profile_frame import sync_sites
    from mcrt_tpu_torch.tools.card import card_line

    cfg = cfg or main_cfg()
    builder = cfg.bvh.builder.name
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    renderer = Renderer(scene, camera, cfg, device=device)
    accel = renderer.intersector.accel
    blocks = getattr(accel, "blas", accel)
    log(f"[{label}] accel {type(accel).__name__} build {time.perf_counter() - t0:.2f} s, "
        f"builder {blocks.builder}, {blocks.num_blocks} blocks, "
        f"{int((blocks.slot_prim >= 0).sum())} references to "
        f"{int(scene.geometry.face_valid.sum())} triangles")
    if blocks.builder != builder.lower():
        raise AssertionError(f"the {builder} build did not run (builder {blocks.builder}): "
                             "the native library failed to build or load")

    kernels.reset_launch_counts()
    # frame 0 counts the rays each query is handed (active lanes), as the
    # JAX bench counts closest plus shadow rays, and the queries and the
    # rays they stage; it is also the warm-up
    traced = torch.zeros((), dtype=torch.int64, device=device)
    queries = {"closest": [0, 0, 0], "occlusion": [0, 0, 0]}  # calls, rays, largest call
    base = renderer.intersector

    def counting(fn, kind):
        def run(s, r):
            nonlocal traced
            traced = traced + r.active.sum()
            q = queries[kind]
            q[0], q[1], q[2] = q[0] + 1, q[1] + r.n, max(q[2], r.n)
            return fn(s, r)
        return run

    renderer.intersector = Intersector(counting(base.intersect, "closest"),
                                       counting(base.occluded, "occlusion"), base.accel)
    _, warm, _ = timed(lambda: renderer.step(1), 1)
    renderer.intersector = base
    rays_per_spp = int(traced)
    ms, frame_ms, _ = timed(lambda: renderer.step(1), MAIN_FRAMES)
    sites = sync_sites(lambda: renderer.step(1))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_no_sync(label, sites)
    img = renderer.display_image().clone()
    log(f"[{label}] counting/warm-up frame {warm[0]:.1f} ms; frames (ms): "
        + ", ".join(f"{t:.1f}" for t in frame_ms))
    mean = img.mean().item()
    if not bool(torch.isfinite(img).all()) or not mean > 0.0:
        raise AssertionError(f"{label}: image not finite/positive (mean {mean})")
    if tuple(img.shape) != (cfg.height, cfg.width, 3):
        raise AssertionError(f"{label}: image shape {tuple(img.shape)}")
    check_launches(label, counts, expect, forbid)
    rays_s = rays_per_spp / (ms / 1e3)
    log(f"[{label}] a sample: {queries['closest'][0]} closest-hit queries of "
        f"{queries['closest'][1]} rays; {queries['occlusion'][0]} occlusion queries (chunks) of "
        f"{queries['occlusion'][1]} staged shadow rays, the largest of "
        f"{queries['occlusion'][2]} rays")
    log(f"[{label}] {cfg.width}x{cfg.height}, {cfg.integrator.max_depth} bounces, "
        f"{cfg.integrator.type.name.lower()}, sobol: {ms:.2f} ms/spp (median of "
        f"{MAIN_FRAMES}), {rays_per_spp} rays/spp, {rays_s:.4e} rays/s, "
        f"image mean {mean:.5f}, launches {counts}, "
        f"peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB; "
        f"card {card_line()}")
    for phase in frame_phases:
        phase(lambda: renderer.step(1), label)
    return counts, ms, rays_s, mean, img


def bdpt_converged_phase(device):
    """``cornell_box`` at 32x16, 512 spp, max_depth 2 (the default RANDOM
    sampler), through ``Renderer`` on the card with the path tracer and with
    BDPT: the mean relative difference outside the directly visible emitter
    must stay under ``BDPT_CONVERGED_REL``.  A t=1 splat routed to the wrong
    ray slot (a square film, or pixels out of the Morton order) scrambles
    whole rows and gives more than 0.5."""
    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.config import IntegratorConfig, IntegratorType, RenderConfig
    from mcrt_tpu_torch.scene.builders import cornell_box
    from mcrt_tpu_torch.tools.card import card_line

    label = "bdpt_converged"
    w, h, spp = 32, 16, 512
    scene, camera = cornell_box(device=device)
    imgs = {}
    kernels.reset_launch_counts()
    for ityp in (IntegratorType.PATH, IntegratorType.BDPT):
        cfg = RenderConfig(width=w, height=h, spp=spp, samples_per_pass=64,
                           integrator=IntegratorConfig(type=ityp, max_depth=2))
        ms, _, img = timed(lambda: Renderer(scene, camera, cfg, device=device).render(), 1)
        imgs[ityp] = img.cpu()
        log(f"[{label}] {ityp.name.lower()} {w}x{h}, {spp} spp, max_depth 2: {ms:.0f} ms "
            f"({ms / spp:.2f} ms/spp), mean {img.mean().item():.5f}; card {card_line()}")
    counts = kernels.launch_counts()
    check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
    a, b = imgs[IntegratorType.PATH], imgs[IntegratorType.BDPT]
    mask = a.amax(-1) < 5.0  # the directly visible emitter
    rel = ((a - b).abs()[mask].mean() / a[mask].mean()).item()
    log(f"[{label}] BDPT against the path tracer outside the emitter: mean relative "
        f"difference {rel:.4f} (bound {BDPT_CONVERGED_REL}), launches {counts}")
    if not rel < BDPT_CONVERGED_REL or not bool(torch.isfinite(b).all()):
        raise AssertionError(f"{label}: BDPT departs from the path tracer: {rel:.4f}")
    return counts


def frames_timed(label, frames):
    """Each callable of ``frames`` (one frame of a phase) under the sync
    check, timed on the host clock between two ``torch.cuda.synchronize()``;
    returns every frame's ms."""
    import collections

    import torch

    from mcrt_tpu_torch.tools.profile_frame import sync_sites

    times, sites = [], collections.Counter()
    for fn in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sites += sync_sites(fn)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check_no_sync(label, sites)
    return times


class RaisingBuild:
    """Stands in for a host build while a phase must refit: any call
    raises.  Restores the module's own function on exit."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __enter__(self):
        self.own = getattr(self.module, self.name)

        def boom(*args, **kwargs):
            raise AssertionError(f"{self.name} ran during a refit-only edit")

        setattr(self.module, self.name, boom)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.own)


def nan_equal(a, b) -> bool:
    import torch

    return torch.equal(torch.nan_to_num(a.cpu(), nan=7.0), torch.nan_to_num(b.cpu(), nan=7.0))


def spp_batch_phase(renderer, device, frames=SPP_BATCH):
    """``render_spp_batch`` over ``frames`` samples of the renderer's scene
    through its intersector: launch counts around it, its time a sample,
    and the result equal to the mean of the same ``render_sample`` calls
    made one by one."""
    import torch

    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.parallel.render import render_spp_batch
    from mcrt_tpu_torch.renderer import render_sample
    from mcrt_tpu_torch.tools.card import card_line

    label = "spp_batch"
    args = (renderer.scene, renderer.camera)
    kernels.reset_launch_counts()
    ms, _, out = timed(lambda: render_spp_batch(*args, range(frames), renderer.cfg,
                                                renderer.intersector), 1)
    counts = kernels.launch_counts()
    check_launches(label, counts, ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7"))
    each = torch.stack([render_sample(*args, f, renderer.cfg, renderer.intersector)[0]
                        for f in range(frames)]).mean(0)
    equal = torch.equal(out, each)
    log(f"[{label}] render_spp_batch of {frames} samples, {WIDTH}x{HEIGHT}, {MAX_DEPTH} "
        f"bounces: {ms:.2f} ms ({ms / frames:.2f} ms/spp), launches {counts}; equal to the "
        f"mean of the same render_sample calls: {equal}; card {card_line()}")
    if not equal or tuple(out.shape) != (WIDTH * HEIGHT, 3) or not out.mean().item() > 0.0:
        raise AssertionError("render_spp_batch differs from the mean of its samples")
    return counts


def animated_phase(r, first):
    """A sphere of ``sphere_field`` (rendered by ``r``) moved for
    ``ANIM_FRAMES`` frames through ``SceneAnimator`` (made from
    ``Renderer.scene``) and ``update_scene``, with the host build replaced
    by a raising stand-in: the refit path only.  Each frame's tables equal
    a CPU refit of the same geometry, bit for bit; each frame agrees with a
    rebuilt ``Renderer``'s; the first moved frame differs from ``first``
    (the unmoved frame 0)."""
    from mcrt_tpu_torch import Renderer
    # two_level binds build_blocked when it is imported: import it before the stand-in
    from mcrt_tpu_torch.accel import blocked, kernels, two_level  # noqa: F401
    from mcrt_tpu_torch.scene.dynamic import SceneAnimator, translation
    from mcrt_tpu_torch.tools.card import card_line, device_timed

    label = "animated"
    camera, device = r.camera, r.device
    base = r.intersector.accel
    anim = SceneAnimator.create(r.scene)
    poses = [translation((0.4 * k, 0.5, 0.3 * k)) for k in range(1, ANIM_FRAMES + 1)]
    kept = []

    def frame(m):
        def run():
            r.update_scene(anim.set_transform(ANIM_SHAPE, m))
            r.step(1)
            kept.append((r.scene, r.intersector.accel, r.display_image().clone()))
        return run

    kernels.reset_launch_counts()
    with RaisingBuild(blocked, "build_blocked"):
        times = frames_timed(label, [frame(m) for m in poses])
    counts = kernels.launch_counts()
    check_launches(label, counts, ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7"))
    t = anim.identity_transforms()
    t[ANIM_SHAPE] = poses[-1]
    moved = kept[-1][0]

    def transform():
        return anim.transformed(t)

    def refit():
        return blocked.refit_blocked(base, moved.geometry)

    tr_ms, refit_ms = (device_timed(f, KERNEL_REPS)[0] for f in (transform, refit))
    tr_host, refit_host = (host_queue_ms(f, KERNEL_REPS) for f in (transform, refit))
    log(f"[{label}] sphere_field, shape {ANIM_SHAPE} moved for {ANIM_FRAMES} frames through "
        f"update_scene, no host build: transform + refit + frame {', '.join(f'{x:.1f}' for x in times)} "
        f"ms (median {statistics.median(times):.2f} ms/spp); card time (the host's time to "
        f"queue it): transform of {moved.geometry.positions.shape[0]} vertices {tr_ms:.3f} "
        f"({tr_host:.3f}) ms, refit_blocked of {base.num_blocks} blocks {refit_ms:.3f} "
        f"({refit_host:.3f}) ms (medians of {KERNEL_REPS}); launches {counts}; card "
        f"{card_line()}")
    cpu_base = base.to("cpu")
    for k, (sc, acc, img) in enumerate(kept):
        cpu = blocked.refit_blocked(cpu_base, sc.geometry.to("cpu"))
        bad = [f for f in ("tri", "aabb", "slot_prim", "bounds", "chunk_aabb")
               if not nan_equal(getattr(acc, f), getattr(cpu, f))]
        if bad or acc.num_blocks != cpu.num_blocks:
            raise AssertionError(f"{label}: frame {k}: the card's refit differs from the "
                                 f"CPU's in {bad}")
        t0 = time.perf_counter()
        rebuilt = Renderer(sc, camera, main_cfg(spp=1), device=device)
        build_s = time.perf_counter() - t0
        agreement(label, f"frame {k} against a rebuilt Renderer (host SAH build "
                  f"{build_s:.2f} s)", img, rebuilt.render())
    log(f"[{label}] refitted tables equal a CPU refit of the same geometry, bit for bit, "
        f"on all {len(kept)} frames")
    changed = 1.0 - agreement(label, "first moved frame against the unmoved frame 0",
                              kept[0][2], first, min_share=0.0)
    if changed < MIN_CHANGED:
        raise AssertionError(f"{label}: moving a sphere changed {changed:.4f} of the pixels")
    return counts


def animated_instanced_phase(device):
    """An instance of ``sphere_field_instanced`` moved by
    ``set_shape_transform`` through ``update_scene``, which must refit
    (``refit_two_level_scene``: host builds replaced by raising
    stand-ins); each frame agrees with a rebuilt ``Renderer``'s, and the
    moved instance's pixels changed (the refit moved ``tw_rows``, which
    K6/K7 read)."""
    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import blocked, kernels, two_level
    from mcrt_tpu_torch.scene.builders import sphere_field_instanced
    from mcrt_tpu_torch.scene.dynamic import set_shape_transform, translation
    from mcrt_tpu_torch.tools.card import card_line, device_timed

    label = "animated_instanced"
    scene, camera = sphere_field_instanced(device=device)
    r = Renderer(scene, camera, main_cfg(spp=1), device=device)
    first = r.render(1).clone()
    base = r.intersector.accel
    home = scene.shapes.to_world[ANIM_SHAPE].cpu().numpy()
    poses = [translation((0.4 * k, 0.5, 0.3 * k)) @ home for k in range(1, ANIM_FRAMES + 1)]
    kept = []

    def frame(m):
        def run():
            r.update_scene(set_shape_transform(r.scene, ANIM_SHAPE, m))
            r.step(1)
            kept.append((r.scene, r.intersector.accel, r.display_image().clone()))
        return run

    kernels.reset_launch_counts()
    with RaisingBuild(two_level, "build_two_level_scene"), RaisingBuild(blocked, "build_blocked"):
        times = frames_timed(label, [frame(m) for m in poses])
    counts = kernels.launch_counts()
    check_launches(label, counts, ("K1", "K6", "K7"), ("K2", "K3", "K4", "K5"))
    moved = kept[-1][0]

    def refit():
        return two_level.refit_two_level_scene(base, moved)

    refit_ms = device_timed(refit, KERNEL_REPS)[0]
    refit_host = host_queue_ms(refit, KERNEL_REPS)
    log(f"[{label}] shape {ANIM_SHAPE} moved for {ANIM_FRAMES} frames: set_shape_transform "
        f"+ refit + frame {', '.join(f'{x:.1f}' for x in times)} ms (median "
        f"{statistics.median(times):.2f} ms/spp); refit_two_level_scene of "
        f"{base.num_pairs} pairs {refit_ms:.3f} ms card time, {refit_host:.3f} ms the host's "
        f"time to queue it (medians of {KERNEL_REPS}); launches {counts}; card {card_line()}")
    cpu_base = base.to("cpu")
    for k, (sc, acc, img) in enumerate(kept):
        cpu = two_level.refit_two_level_scene(cpu_base, sc.to("cpu"))
        bad = [f for f in ("world_to_object", "tw_rows", "pair_aabb", "pair_chunk", "bounds")
               if not nan_equal(getattr(acc, f), getattr(cpu, f))]
        if bad:
            raise AssertionError(f"{label}: frame {k}: the card's refit differs from the "
                                 f"CPU's in {bad}")
        agreement(label, f"frame {k} against a rebuilt Renderer", img,
                  Renderer(sc, camera, main_cfg(spp=1), device=device).render())
    changed = 1.0 - agreement(label, "first moved frame against the unmoved frame 0",
                              kept[0][2], first, min_share=0.0)
    if changed < MIN_CHANGED:
        raise AssertionError(f"{label}: moving an instance changed {changed:.4f} of the "
                             "pixels: were the world rows refitted?")
    return counts


def texbox_phase(device):
    """``scene_from_obj`` of the committed ``tests/assets/texbox.obj``: two
    textures decoded (no imaging library), CUDA-vs-CPU parity at 64x64 as
    ``parity_phase``, then the golden ``tests/goldens/texbox.npz`` at its
    own settings through ``AUTO`` (32x32, 16 spp, max_depth 3, RANDOM)
    within its own bound, with the launch counters around that render."""
    import numpy as np
    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.config import (IntegratorConfig, RenderConfig, SamplerConfig,
                                       SamplerType)
    from mcrt_tpu_torch.scene.builders import scene_from_obj

    label = "texbox"
    had_pil = "PIL" in sys.modules
    scene, camera = scene_from_obj(TEXBOX, camera_kw=TEXBOX_CAMERA, device=device)
    if "PIL" in sys.modules and not had_pil:
        raise AssertionError("scene_from_obj imported an imaging library")
    log(f"[{label}] {int(scene.geometry.face_valid.sum())} triangles, "
        f"{scene.textures.num} textures decoded ({scene.textures.data.shape[1]} texels)")
    if scene.textures.num != 2:
        raise AssertionError(f"{label}: {scene.textures.num} textures, expected 2")
    cfg = RenderConfig(width=64, height=64, spp=1, sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=3))
    card, cpu = (Renderer(*scene_from_obj(TEXBOX, camera_kw=TEXBOX_CAMERA, device=dev), cfg,
                          device=dev).render().cpu() for dev in (device, "cpu"))
    agreement(label, "64x64 sobol, CUDA against CPU", card, cpu)
    golden = RenderConfig(width=32, height=32, spp=16, samples_per_pass=16,
                          integrator=IntegratorConfig(max_depth=3))
    kernels.reset_launch_counts()
    img = Renderer(scene, camera, golden, device=device).render()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
    ref = np.load(GOLDEN)["image"].astype(np.float32)
    rel = float(np.abs(img.cpu().numpy() - ref).mean() / max(float(ref.mean()), 1e-6))
    log(f"[{label}] golden {os.path.basename(GOLDEN)} (32x32, 16 spp, max_depth 3, random) "
        f"through AUTO: mean-relative error {rel:.5f} (bound {GOLDEN_REL}), launches {counts}")
    if not rel < GOLDEN_REL or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: golden mean-relative error {rel:.5f}")
    return scene, camera


def check_grads(label, grads, nonzero):
    """Every gradient finite, and those of the fields ``nonzero`` not all
    zero; logs each field's largest |g|."""
    import torch

    log(f"[{label}] gradients: " + ", ".join(
        f"{k} {tuple(g.shape)} max |g| {g.abs().max().item():.4e}" for k, g in grads.items()))
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    zero = [k for k in nonzero if not grads[k].abs().sum().item() > 0.0]
    if bad or zero:
        raise AssertionError(f"{label}: gradients not finite {bad} or all zero {zero}")


def grad_phase(label, scene, camera, device, view_name, expect, forbid, nonzero, size=WIDTH,
               spp=1, depth=MAX_DEPTH, frame_phases=()):
    """A gradient step (``make_train_step``, the mean squared error against
    a render of other samples) on ``scene`` at ``size``^2, Sobol, ``depth``
    bounces, ``spp`` samples, with ``view_name``'s parameters: the forward
    loss under ``torch.no_grad()`` and the step (forward and backward) are
    timed ``GRAD_STEPS`` times each (median) with the launch counters set to
    0 just before and read just after; prints both, their ratio (the JAX
    bench's ``grad_overhead_ratio``) and the peak memory.  The gradients
    must be finite and those of ``nonzero`` not all zero.  Then each of
    ``frame_phases(step, label)`` on one more step.  Returns (launch
    counts, forward ms, step ms, peak GiB)."""
    import torch

    from mcrt_tpu_torch.accel import build_intersector, kernels
    from mcrt_tpu_torch.diff import estimators
    from mcrt_tpu_torch.parallel.render import make_train_step, render_spp_batch
    from mcrt_tpu_torch.tools.card import card_line

    cfg = main_cfg(spp=spp, size=size, depth=depth)
    isect = build_intersector(scene, cfg)
    view = getattr(estimators, view_name)()
    frames = list(range(spp))
    with torch.no_grad():
        target = render_spp_batch(scene, camera, [f + 1000 for f in frames], cfg, isect)
    loss_fn = estimators.render_loss_fn(camera, cfg, isect, view)
    step = make_train_step(camera, cfg, isect, None, view.get, view.set)
    params = view.get(scene)

    def forward():
        with torch.no_grad():
            return loss_fn(params, scene, frames, target)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    step(scene, frames, target)  # warm-up
    fwd_ms, fwd_all, fwd_loss = timed(forward, GRAD_STEPS)
    step_ms, step_all, (loss, grads) = timed(lambda: step(scene, frames, target), GRAD_STEPS)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    check_launches(label, counts, expect, forbid)
    check_grads(label, grads, nonzero)
    if not (bool(torch.isfinite(loss)) and torch.isclose(loss, fwd_loss, rtol=1e-5)):
        raise AssertionError(f"{label}: the step's loss {loss.item()} is not finite or not "
                             f"the forward loss {fwd_loss.item()} (rtol 1e-5)")
    log(f"[{label}] {size}x{size}, {depth} bounces, {spp} spp, {view_name}: forward "
        f"{fwd_ms:.2f} ms, forward+backward {step_ms:.2f} ms, ratio {step_ms / fwd_ms:.3f} "
        f"(median of {GRAD_STEPS}; forward " + ", ".join(f"{t:.1f}" for t in fwd_all)
        + "; step " + ", ".join(f"{t:.1f}" for t in step_all) + f"), loss {loss.item():.6e}, "
        f"peak memory {peak:.2f} GiB, launches {counts}; card {card_line()}")
    for phase in frame_phases:
        phase(lambda: step(scene, frames, target), label)
    return counts, fwd_ms, step_ms, peak


def wrong_albedo(scene):
    """``scene`` with the red wall's albedo (material 1) set to grey 0.3,
    the start of ``tests/test_torch_inverse.py``'s albedo recovery."""
    diffuse = scene.materials.diffuse.clone()
    diffuse[1] = 0.3
    return scene.replace(materials=scene.materials.replace(diffuse=diffuse))


def inverse_phase(device):
    """BASELINE configuration 5 at full width: ``InverseRenderer`` on
    ``cornell_box`` (K4/K5) at 512x512, depth 8, Sobol, ``full_params``,
    ``INVERSE_STEPS`` Adam steps of 1 spp each, from the wrong red-wall
    albedo towards a 4-spp render of the true scene, with the launch
    counters set to 0 just before and read just after.  Prints each step's
    loss and host time (a step ends reading its loss, so the card has
    finished it) and the peak memory; the losses must be finite.  Then one
    more step holds every K4/K5 launch against its plain version."""
    import torch

    from mcrt_tpu_torch.accel import build_intersector, kernels
    from mcrt_tpu_torch.diff import estimators
    from mcrt_tpu_torch.parallel.render import render_spp_batch
    from mcrt_tpu_torch.scene.builders import cornell_box
    from mcrt_tpu_torch.tools.card import card_line

    label = "inverse"
    scene, camera = cornell_box(device=device)
    cfg = main_cfg(spp=1)
    with torch.no_grad():
        target = render_spp_batch(scene, camera, range(4), cfg, build_intersector(scene, cfg))
    inv = estimators.InverseRenderer(wrong_albedo(scene), camera, cfg,
                                     estimators.full_params(), learning_rate=0.05)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    marks = [time.perf_counter()]
    _, params, losses = inv.run(target, steps=INVERSE_STEPS, spp_per_step=1, seed=0,
                                callback=lambda i, p, loss: marks.append(time.perf_counter()))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
    log(f"[{label}] cornell_box {WIDTH}x{HEIGHT}, {MAX_DEPTH} bounces, 1 spp a step, "
        f"full_params: losses " + ", ".join(f"{v:.6e}" for v in losses) + "; ms a step "
        + ", ".join(f"{t:.1f}" for t in step_ms) + f" (median {statistics.median(step_ms):.1f}"
        f"), peak memory {peak:.2f} GiB, launches {counts}; card {card_line()}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    if not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise AssertionError(f"{label}: a parameter is not finite after the steps")
    dense_frame_phase(lambda: inv.run(target, steps=1, spp_per_step=1, seed=0), label)
    return counts


def inverse_recover_phase(device):
    """``tests/test_torch_inverse.py``'s albedo recovery on the card, at its
    size and criteria: ``cornell_box`` 16x16, depth 2, 8 spp a step, 60
    Adam steps at learning rate 0.1 on the same streams as the target; the
    last loss below 10% of the first, the red wall's albedo within 0.15."""
    import torch

    from mcrt_tpu_torch.accel import build_intersector, kernels
    from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig
    from mcrt_tpu_torch.diff import estimators
    from mcrt_tpu_torch.parallel.render import render_spp_batch
    from mcrt_tpu_torch.scene.builders import cornell_box
    from mcrt_tpu_torch.tools.card import card_line

    label = "inverse_recover"
    scene, camera = cornell_box(device=device)
    cfg = RenderConfig(width=16, height=16, spp=8, integrator=IntegratorConfig(max_depth=2))
    with torch.no_grad():
        target = render_spp_batch(scene, camera, range(8), cfg, build_intersector(scene, cfg))
    inv = estimators.InverseRenderer(wrong_albedo(scene), camera, cfg,
                                     estimators.material_params(), learning_rate=0.1)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    recovered, _, losses = inv.run(target, steps=60, spp_per_step=8, seed=0,
                                   advance_frames=False)
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    got = recovered.materials.diffuse[1].cpu()
    want = scene.materials.diffuse[1].cpu()
    err = (got - want).abs().max().item()
    log(f"[{label}] 60 steps in {secs:.2f} s: loss {losses[0]:.6e} -> {losses[-1]:.6e} "
        f"({losses[-1] / losses[0]:.4f} of the first, bound 0.1), albedo {got.tolist()} "
        f"against {want.tolist()} (max error {err:.4f}, bound 0.15), launches {counts}; "
        f"card {card_line()}")
    check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
    if not losses[-1] < 0.1 * losses[0] or not err <= 0.15:
        raise AssertionError(f"{label}: the albedo was not recovered")
    return counts


def grad_parity_phase(device):
    """Card gradients against CPU gradients (``tools/grad_check.py``) at
    ``tests/test_torch_diff.py``'s sizes, depth 2: ``cornell_box``
    ``material_params`` and ``light_params`` (16x16, 16 spp) and
    ``textured_hall`` texels (12x12, 4 spp), over the (sample, pixel)
    pairs whose forward radiance agrees (at least 99%), each field within
    ``GRAD_TOL``."""
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.scene.builders import cornell_box, textured_hall
    from mcrt_tpu_torch.tools import grad_check

    label = "grad_parity"
    kernels.reset_launch_counts()
    for builder, view, size, spp, floats in (
            (cornell_box, "material_params", 16, 16, False),
            (cornell_box, "light_params", 16, 16, False),
            (textured_hall, "texture_params", 12, 4, True)):
        share, grads = grad_check.device_parity(builder, view, size, spp, 2, device, floats)
        cmp = grad_check.compare(grads)
        log(f"[{label}] {builder.__name__} {view}: samples agreeing {share:.4f}; " + ", ".join(
            f"{k} max |card - cpu| {e:.3e} of max |g| {sc:.4e} ({'within' if ok else 'OUTSIDE'}"
            f" rtol {grad_check.GRAD_TOL[k][0]:g} + {grad_check.GRAD_TOL[k][1]:g} max)"
            for k, (e, sc, ok) in cmp.items()))
        if share < grad_check.MIN_AGREE or not all(ok for _, _, ok in cmp.values()):
            raise AssertionError(f"{label}: {builder.__name__} {view}: card gradients depart "
                                 "from the CPU's")
    counts = kernels.launch_counts()
    check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
    return counts


GRAD_PHASES = ("grad", "grad_128", "inverse", "inverse_recover", "grad_parity")


def grad_phases(scene, camera, device):
    """Phase 7, inverse rendering, outside ``torch.no_grad()``: returns
    each phase's launch counts."""
    k1_3, k4_5, k6_7 = ("K1", "K2", "K3"), ("K4", "K5"), ("K6", "K7")
    walk = partial(walk_frame_phase, ids=("K2", "K3"))
    return {
        "grad": grad_phase("grad", scene, camera, device, "full_params", k1_3, k4_5 + k6_7,
                           ("diffuse", "roughness", "intensity"),
                           frame_phases=(cull_frame_phase, walk))[0],
        "grad_128": grad_phase("grad_128", scene, camera, device, "material_params", k1_3,
                               k4_5 + k6_7, ("diffuse", "roughness"), size=128, spp=2,
                               depth=3)[0],
        "inverse": inverse_phase(device),
        "inverse_recover": inverse_recover_phase(device),
        "grad_parity": grad_parity_phase(device),
    }


BDPT_PHASES = ("bdpt", "bdpt_128", "bdpt_dense", "bdpt_instanced")


def bdpt_phases(scene, camera, device):
    """BDPT through ``Renderer`` (Sobol, SAH blocks, ``AUTO``) on the three
    paths: ``sphere_field`` at 512x512, depth 8 (K1-K3), and at 128x128,
    depth 3; ``cornell_box`` at 512x512, depth 8 (K4/K5);
    ``sphere_field_instanced`` at 512x512, depth 3 (K1, K6, K7).  After the
    timed frames of each 512x512 path, one frame more for each of its
    kernels holds every launch of the kernel against its plain version, a
    full occlusion chunk of 2^21 rays among them for K1, K3, K5 and K7."""
    from mcrt_tpu_torch.scene.builders import cornell_box, sphere_field_instanced

    k1_3, k4_5, k6_7 = ("K1", "K2", "K3"), ("K4", "K5"), ("K6", "K7")
    cull = partial(cull_frame_phase, chunk=True)
    return {
        "bdpt": main_path_phase(
            "bdpt", scene, camera, device, k1_3, k4_5 + k6_7, cfg=main_cfg(integrator="BDPT"),
            frame_phases=(cull, partial(walk_frame_phase, ids=("K2", "K3"), chunk="K3"))),
        "bdpt_128": main_path_phase("bdpt_128", scene, camera, device, k1_3, k4_5 + k6_7,
                                    cfg=main_cfg(integrator="BDPT", size=128, depth=3)),
        "bdpt_dense": main_path_phase(
            "bdpt_dense", *cornell_box(device=device), device, k4_5, k1_3 + k6_7,
            cfg=main_cfg(integrator="BDPT"),
            frame_phases=(partial(dense_frame_phase, chunk=True),)),
        "bdpt_instanced": main_path_phase(
            "bdpt_instanced", *sphere_field_instanced(device=device), device, ("K1",) + k6_7,
            ("K2", "K3") + k4_5, cfg=main_cfg(integrator="BDPT", depth=3),
            frame_phases=(cull, partial(walk_frame_phase, ids=k6_7, chunk="K7"))),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mcrt_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.scene.builders import sphere_field_instanced, textured_hall
    from mcrt_tpu_torch.tools.card import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    log(card_line())
    t0 = time.perf_counter()
    path = kernels.build()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    res = KernelResults()
    with torch.no_grad():
        vpu_counts = vpu_kernels(res, device)
        scene, camera = visit_list_kernels(res, device)
        dense_kernels(res, device)
        two_level_kernels(res, device)
        for name in ("glass_gallery", "textured_hall", "instanced_boxes"):
            parity_phase(name)
        parity_phase("glass_gallery", "RANDOM")
        random_draw_phase(device)
        paths = {
            "main": main_path_phase("main", scene, camera, device, ("K1", "K2", "K3"), (),
                                    frame_phases=(cull_frame_phase,)),
            "dense": main_path_phase("dense", *textured_hall(device=device), device,
                                     ("K4", "K5"), ("K1", "K2", "K3"),
                                     frame_phases=(dense_frame_phase,)),
            "instanced": main_path_phase("instanced", *sphere_field_instanced(device=device),
                                         device, ("K1", "K6", "K7"), ("K2", "K3", "K4", "K5")),
            "sbvh": main_path_phase("sbvh", scene, camera, device, ("K1", "K2", "K3"),
                                    ("K4", "K5", "K6", "K7"), cfg=main_cfg("SBVH")),
        }
        agreement("sbvh", "against the SAH render of the same frames", paths["sbvh"][4],
                  paths["main"][4])
        r = Renderer(scene, camera, main_cfg(spp=1), device=device)
        first = r.render(1).clone()  # frame 0, unmoved
        phase_counts = {label: v[0] for label, v in paths.items()}
        phase_counts["spp_batch"] = spp_batch_phase(r, device)
        phase_counts["animated"] = animated_phase(r, first)
        phase_counts["animated_instanced"] = animated_instanced_phase(device)
        texbox, texbox_camera = texbox_phase(device)
        paths["texbox"] = main_path_phase("texbox", texbox, texbox_camera, device, ("K4", "K5"),
                                          ("K1", "K2", "K3", "K6", "K7"))
        phase_counts["texbox"] = paths["texbox"][0]
        paths.update(bdpt_phases(scene, camera, device))
        for name in ("cornell_box", "glass_gallery"):
            parity_phase(name, integrator="BDPT")
        phase_counts["bdpt_converged"] = bdpt_converged_phase(device)
        phase_counts.update({label: paths[label][0] for label in BDPT_PHASES})
    phase_counts.update(grad_phases(scene, camera, device))
    baked, inst = paths["main"][3], paths["instanced"][3]
    log(f"[instanced] image mean {inst:.6f} against the baked sphere_field's {baked:.6f} "
        f"(relative difference {abs(inst - baked) / baked:.2e}, limit {INSTANCED_MEAN_RTOL})")
    if abs(inst - baked) > INSTANCED_MEAN_RTOL * baked:
        raise AssertionError("the instanced render's mean departs from the baked render's")

    path_of = {"K1": "main", "K2": "main", "K3": "main", "K4": "dense", "K5": "dense",
               "K6": "instanced", "K7": "instanced"}
    launches = {k: paths[p][0][k] for k, p in path_of.items()}
    launches.update(K8=vpu_counts["K8"], K9=vpu_counts["K9"])
    kernel_rows = []
    for k, (name, source, replaces) in KERNELS.items():
        r = res.rows[k]
        b_ms, by = r["bound"][-1]
        kernel_rows.append({
            "name": f"{k} {name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k],
            "launches_by_path": {p: c[k] for p, c in phase_counts.items() if c[k]},
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"][-1], "plain_ms": r["plain_ms"][-1], "bound_ms": b_ms,
            "bound_by": by, "library_ms": r["library_ms"], "variants": r["variants"]})
    log("[paths] card: " + card_line() + "; " + "; ".join(
        f"{label} {v[1]:.2f} ms/spp, {v[2]:.4e} rays/s" for label, v in paths.items()))
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
