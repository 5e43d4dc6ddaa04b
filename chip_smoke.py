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
kernel, ``vpu_bench.main()`` for K8/K9; each row's ``variants`` map holds
every wavefront's or variant's ``ms``, ``plain_ms``, ``bound_ms``,
``bound_by`` and ``library_ms``, and for K8 (float32, bfloat16) and K9
(k=8, k=128) also ``issue_floor_ms`` and ``sm_mhz``), the last one
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

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


def parity_phase(name: str, sampler: str = "SOBOL"):
    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.config import (IntegratorConfig, RenderConfig,
                                       SamplerConfig, SamplerType)
    from mcrt_tpu_torch.scene import builders

    cfg = RenderConfig(width=64, height=64, spp=1,
                       sampler=SamplerConfig(type=SamplerType[sampler]),
                       integrator=IntegratorConfig(max_depth=3))
    label = f"{name} ({sampler.lower()})"
    images = {}
    for dev in ("cuda", "cpu"):
        scene, camera = getattr(builders, name)(device=dev)
        t0 = time.perf_counter()
        images[dev] = Renderer(scene, camera, cfg, device=dev).render().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"[parity] {label} 64x64 on {dev}: {time.perf_counter() - t0:.2f} s")
    close = torch.isclose(images["cuda"], images["cpu"], rtol=1e-3, atol=1e-4).all(dim=-1)
    share = close.float().mean().item()
    log(f"[parity] {label}: pixels agreeing (rtol 1e-3, atol 1e-4): {share:.4f} "
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


def cull_frame_phase(renderer, label):
    """The inputs K1 is handed during one frame of ``renderer``: each
    launch's keys equal to the plain version's; K1's time on each (median
    of ``KERNEL_REPS``) and its bound, summed over the frame."""
    import torch

    from mcrt_tpu_torch.accel import blocked, kernels
    from mcrt_tpu_torch.tools.wavefronts import inputs_of_a_frame

    inputs = inputs_of_a_frame(renderer, ["K1"])["K1"]
    total_ms = total_bound = 0.0
    for packed, chunk, boxes, tile in inputs:
        ms, _, keys = kernel_timed(lambda: kernels.cull(packed, chunk, boxes, tile), KERNEL_REPS)
        if not torch.equal(keys, blocked.cull_plain(packed, chunk, boxes, tile)):
            raise AssertionError(f"{label}: K1 keys of a frame's launch differ from the "
                                 "plain version")
        b_ms, _ = bound(blocked.cull_tests(packed, chunk, boxes, tile) * OPS_SLAB,
                        nbytes(packed, chunk, boxes, keys))
        total_ms += ms
        total_bound += b_ms
    log(f"[{label}] K1 a frame: {total_ms:.4f} ms, bound {total_bound:.4f} ms, "
        f"{len(inputs)} launches (keys equal to the plain version's on each)")


def dense_frame_phase(renderer, label):
    """The inputs K4 and K5 are handed during one frame of ``renderer``:
    each launch's outputs equal to the plain version's (as in the kernel
    phase); the kernels' time on each (median of ``KERNEL_REPS``) and their
    bound, summed over the frame's launches of both."""
    from mcrt_tpu_torch.accel import blocked, kernels
    from mcrt_tpu_torch.tools.wavefronts import inputs_of_a_frame

    inputs = inputs_of_a_frame(renderer, ["K4", "K5"])
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


def main_path_phase(label, scene, camera, device, expect, forbid, frame_phase=None):
    """``Renderer`` on ``scene``: returns (launch counts, ms/spp, rays/s,
    image mean); then ``frame_phase(renderer, label)``, if given, on one
    more frame."""
    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import Intersector, kernels
    from mcrt_tpu_torch.config import (BuilderType, BVHConfig, IntegratorConfig,
                                       RenderConfig, SamplerConfig, SamplerType)
    from mcrt_tpu_torch.tools.profile_frame import sync_sites
    from mcrt_tpu_torch.tools.card import card_line

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=MAIN_FRAMES + 3,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       bvh=BVHConfig(builder=BuilderType.SAH),
                       integrator=IntegratorConfig(max_depth=MAX_DEPTH))
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    renderer = Renderer(scene, camera, cfg, device=device)
    accel = renderer.intersector.accel
    blocks = getattr(accel, "blas", accel)
    log(f"[{label}] accel {type(accel).__name__} build {time.perf_counter() - t0:.2f} s, "
        f"builder {blocks.builder}, {blocks.num_blocks} blocks")
    if blocks.builder != "sah":
        raise AssertionError(f"the SAH build did not run (builder {blocks.builder}): "
                             "the native library failed to build or load")

    kernels.reset_launch_counts()
    # frame 0 counts the rays each query is handed (active lanes), as the
    # JAX bench counts closest plus shadow rays; it is also the warm-up
    traced = torch.zeros((), dtype=torch.int64, device=device)
    base = renderer.intersector

    def counting(fn):
        def run(s, r):
            nonlocal traced
            traced = traced + r.active.sum()
            return fn(s, r)
        return run

    renderer.intersector = Intersector(counting(base.intersect),
                                       counting(base.occluded), base.accel)
    _, warm, _ = timed(lambda: renderer.step(1), 1)
    renderer.intersector = base
    rays_per_spp = int(traced)
    ms, frame_ms, _ = timed(lambda: renderer.step(1), MAIN_FRAMES)
    sites = sync_sites(lambda: renderer.step(1))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[{label}] synchronizing calls in one frame: {sum(sites.values())} "
        + ", ".join(f"{site} x{n}" for site, n in sites.most_common()))
    if sites:
        raise AssertionError(f"{label}: the frame waits for the card at {dict(sites)}")
    img = renderer.display_image()
    log(f"[{label}] counting/warm-up frame {warm[0]:.1f} ms; frames (ms): "
        + ", ".join(f"{t:.1f}" for t in frame_ms))
    mean = img.mean().item()
    if not bool(torch.isfinite(img).all()) or not mean > 0.0:
        raise AssertionError(f"{label}: image not finite/positive (mean {mean})")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"{label}: image shape {tuple(img.shape)}")
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched on the main path: {missing}")
    stray = [k for k in forbid if counts[k]]
    if stray:
        raise AssertionError(f"{label}: kernels of another path launched: {stray}")
    rays_s = rays_per_spp / (ms / 1e3)
    log(f"[{label}] {WIDTH}x{HEIGHT}, {MAX_DEPTH} bounces, sobol: {ms:.2f} ms/spp (median of "
        f"{MAIN_FRAMES}), {rays_per_spp} rays/spp, {rays_s:.4e} rays/s, "
        f"image mean {mean:.5f}, launches {counts}, "
        f"peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB; "
        f"card {card_line()}")
    if frame_phase:
        frame_phase(renderer, label)
    return counts, ms, rays_s, mean


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mcrt_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
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
                                    frame_phase=cull_frame_phase),
            "dense": main_path_phase("dense", *textured_hall(device=device), device,
                                     ("K4", "K5"), ("K1", "K2", "K3"),
                                     frame_phase=dense_frame_phase),
            "instanced": main_path_phase("instanced", *sphere_field_instanced(device=device),
                                         device, ("K1", "K6", "K7"), ("K2", "K3", "K4", "K5")),
        }
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
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
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
