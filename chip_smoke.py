#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mcrt_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

0. Set-up: requires ``torch.cuda.is_available()``; builds the blocked
   intersector kernels K1-K3 from ``mcrt_tpu_torch/csrc`` with nvcc; prints
   the card's name and power limit as nvidia-smi reports them.
1. Kernels: on a ~245k-triangle scene, runs K1 cull, K2 closest hit and K3
   any hit against their plain PyTorch versions on the card, on a 512x512
   wavefront of primary rays and one of random bounce rays, and times both.
   K1 keys must be equal, K2 hit flags and slots equal and t within rtol
   1e-5 where both hit, K3 flags equal: the kernels compute the plain
   versions' formulas without fused multiply-add, in the same order.  The
   share of differing rays is printed as a diagnostic.
2. Render parity: ``glass_gallery`` at 64x64, 1 spp, Sobol, max_depth 3,
   once on the card (kernels) and once on the CPU (plain versions) with the
   same port code; at least 99% of pixels must agree to rtol 1e-3 / atol
   1e-4.
3. Main path: ``Renderer`` on the 245k-triangle scene at 512x512, 8 bounces,
   Sobol, SAH blocks, for a few progressive frames.  The accel must have
   been built by the SAH builder, the image must be finite with a positive
   mean, every kernel's launch counter must have moved during this phase,
   and a frame run under torch's CUDA sync debug mode must make no
   synchronizing call (the host never waits for the card inside a frame).
   Prints ms per spp and rays/s (closest plus shadow rays actually traced).

The second-to-last stdout line is the per-kernel JSON record (``ms`` and
``plain_ms`` there are the bounce wavefront's, the shape of seven of the
main path's eight bounces; the log lines give both wavefronts), the last
one ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

WIDTH = HEIGHT = 512
MAX_DEPTH = 8
MAIN_FRAMES = 4  # timed progressive frames of the main path
KERNEL_REPS = 5  # timed calls per kernel (median reported)
PLAIN_REPS = 2
PARITY_MIN_SHARE = 0.99
REPLACES = {
    "K1": "mcrt_tpu/accel/pallas_blocked.py:551",  # _cull_kernel
    "K2": "mcrt_tpu/accel/pallas_blocked.py:733",  # _closest_kernel
    "K3": "mcrt_tpu/accel/pallas_blocked.py:798",  # _occluded_kernel
}
NAMES = {"K1": "cull", "K2": "closest", "K3": "occluded"}


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def wavefronts(scene, camera, accel, device):
    """A 512x512 wavefront of primary rays (Morton pixel order, as the
    renderer traces them) and one of random bounce rays leaving the primary
    hits in uniformly random directions."""
    import torch

    from mcrt_tpu_torch.accel.blocked import intersect_blocked
    from mcrt_tpu_torch.camera.pinhole import pixel_uv
    from mcrt_tpu_torch.core.types import Rays
    from mcrt_tpu_torch.renderer import morton_pixel_order

    order, _ = morton_pixel_order(WIDTH, HEIGHT)
    uv = pixel_uv(WIDTH, HEIGHT, device=device)[torch.as_tensor(order, device=device).long()]
    o, d = camera.generate_rays(uv)
    primary = Rays.make(o.contiguous(), d)
    hit = intersect_blocked(scene.geometry, accel, primary)
    g = torch.Generator(device=device)
    g.manual_seed(1234)
    n = primary.n
    dirs = torch.randn((n, 3), generator=g, device=device)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    p = primary.at(torch.where(hit.valid, hit.t, 0.0)) + dirs * 1e-3
    seg = 0.5 + 4.5 * torch.rand((n,), generator=g, device=device)
    bounce = Rays.make(p, dirs, tmax=seg, active=hit.valid)
    return {"primary": primary, "bounce": bounce}


def kernel_phase(scene, camera, accel, device):
    import torch

    from mcrt_tpu_torch.accel import blocked, kernels

    results = {k: {"ms": [], "plain_ms": [], "max_abs_err": 0.0} for k in NAMES}
    tile, group = blocked.TILE, blocked.GROUP
    for name, rays in wavefronts(scene, camera, accel, device).items():
        packed, _ = blocked._sorted_table(rays, accel, True)
        live = int(rays.active.sum())
        # K1
        ms, _, keys = timed(lambda: kernels.cull(packed, accel.chunk_aabb, accel.aabb, tile),
                            KERNEL_REPS)
        pms, _, keys_p = timed(lambda: blocked.cull_plain(packed, accel.chunk_aabb,
                                                          accel.aabb, tile), PLAIN_REPS)
        if not torch.equal(keys, keys_p):
            bad = (keys != keys_p).float().mean().item()
            raise AssertionError(f"K1 keys differ from the plain version ({name}): share {bad}")
        entered = keys < 0.5 * blocked.BIG
        err = (keys[entered] - keys_p[entered]).abs().max().item() if entered.any() else 0.0
        _record(results["K1"], ms, pms, err)
        counts, lists, tn_sorted = blocked.lists_from_keys(keys)
        log(f"[kernels:{name}] {live} live rays, {int(counts.sum())} visits "
            f"over {counts.numel()} tiles; K1 {ms:.3f} ms (plain {pms:.3f} ms), keys equal")
        # K2
        ms, _, (t_k, s_k) = timed(lambda: kernels.closest(
            counts, packed, lists, tn_sorted, accel.tri, tile, group), KERNEL_REPS)
        pms, _, (t_p, s_p) = timed(lambda: blocked.closest_plain(
            counts, packed, lists, tn_sorted, accel.tri, tile, group), PLAIN_REPS)
        hk, hp = s_k >= 0, s_p >= 0
        both = hk & hp
        t_ok = torch.isclose(t_k, t_p, rtol=1e-5, atol=0.0) | ~both
        share = ((hk != hp) | ~t_ok | (s_k != s_p)).float().mean().item()
        err = (t_k[both] - t_p[both]).abs().max().item() if both.any() else 0.0
        log(f"[kernels:{name}] K2 {ms:.3f} ms (plain {pms:.3f} ms): {int(hk.sum())} hits, "
            f"differing share {share:.2e}, max |dt| {err:.3e}")
        if not (torch.equal(hk, hp) and torch.equal(s_k, s_p) and bool(t_ok.all())):
            raise AssertionError(f"K2 differs from the plain version ({name}): "
                                 f"share {share:.2e}")
        _record(results["K2"], ms, pms, err)
        # K3
        ms, _, b_k = timed(lambda: kernels.occluded(
            counts, packed, lists, accel.tri, tile, group), KERNEL_REPS)
        pms, _, b_p = timed(lambda: blocked.occluded_plain(
            counts, packed, lists, accel.tri, tile, group), PLAIN_REPS)
        share = (b_k != b_p).float().mean().item()
        log(f"[kernels:{name}] K3 {ms:.3f} ms (plain {pms:.3f} ms): "
            f"{int(b_k.sum())} blocked, differing share {share:.2e}")
        if not torch.equal(b_k, b_p):
            raise AssertionError(f"K3 differs from the plain version ({name}): "
                                 f"share {share:.2e}")
        _record(results["K3"], ms, pms, (b_k - b_p).abs().max().item())
    return results


def _record(r, ms, plain_ms, err):
    r["ms"].append(ms)
    r["plain_ms"].append(plain_ms)
    r["max_abs_err"] = max(r["max_abs_err"], err)


def parity_phase():
    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.config import (IntegratorConfig, RenderConfig,
                                       SamplerConfig, SamplerType)
    from mcrt_tpu_torch.scene.builders import glass_gallery

    cfg = RenderConfig(width=64, height=64, spp=1,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=3))
    images = {}
    for dev in ("cuda", "cpu"):
        scene, camera = glass_gallery(device=dev)
        t0 = time.perf_counter()
        images[dev] = Renderer(scene, camera, cfg, device=dev).render().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"[parity] glass_gallery 64x64 on {dev}: {time.perf_counter() - t0:.2f} s")
    close = torch.isclose(images["cuda"], images["cpu"], rtol=1e-3, atol=1e-4).all(dim=-1)
    share = close.float().mean().item()
    log(f"[parity] pixels agreeing (rtol 1e-3, atol 1e-4): {share:.4f} "
        f"(mismatch {1 - share:.4f}); means {images['cuda'].mean():.5f} / "
        f"{images['cpu'].mean():.5f}")
    if share < PARITY_MIN_SHARE:
        raise AssertionError(f"CUDA-vs-CPU render parity {share:.4f} < {PARITY_MIN_SHARE}")
    return share


def main_path_phase(scene, camera, device):
    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import Intersector, kernels
    from mcrt_tpu_torch.config import (BuilderType, BVHConfig, IntegratorConfig,
                                       RenderConfig, SamplerConfig, SamplerType)
    from mcrt_tpu_torch.tools.profile_frame import sync_sites

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=MAIN_FRAMES + 2,
                       sampler=SamplerConfig(type=SamplerType.SOBOL),
                       bvh=BVHConfig(builder=BuilderType.SAH),
                       integrator=IntegratorConfig(max_depth=MAX_DEPTH))
    t0 = time.perf_counter()
    renderer = Renderer(scene, camera, cfg, device=device)
    builder = renderer.intersector.accel.builder
    log(f"[main] accel build {time.perf_counter() - t0:.2f} s, builder {builder}, "
        f"{renderer.intersector.accel.num_blocks} blocks")
    if builder != "sah":
        raise AssertionError(f"the SAH build did not run (builder {builder}): "
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
    log(f"[main] synchronizing calls in one frame: {sum(sites.values())} "
        + ", ".join(f"{site} x{n}" for site, n in sites.most_common()))
    if sites:
        raise AssertionError(f"the frame waits for the card at {dict(sites)}")
    img = renderer.display_image()
    log(f"[main] counting/warm-up frame {warm[0]:.1f} ms; frames (ms): "
        + ", ".join(f"{t:.1f}" for t in frame_ms))
    mean = img.mean().item()
    if not bool(torch.isfinite(img).all()) or not mean > 0.0:
        raise AssertionError(f"main-path image not finite/positive (mean {mean})")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"main-path image shape {tuple(img.shape)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    rays_s = rays_per_spp / (ms / 1e3)
    log(f"[main] {WIDTH}x{HEIGHT}, {MAX_DEPTH} bounces, sobol: {ms:.2f} ms/spp (median of "
        f"{MAIN_FRAMES}), {rays_per_spp} rays/spp, {rays_s:.4e} rays/s, "
        f"image mean {mean:.5f}, launches {counts}, "
        f"peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    return counts, ms, rays_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mcrt_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.accel.blocked import build_blocked
    from mcrt_tpu_torch.scene.builders import sphere_field

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

    with torch.no_grad():
        t0 = time.perf_counter()
        scene, camera = sphere_field(device=device)
        n_tris = int(scene.geometry.face_valid.sum())
        accel = build_blocked(scene.geometry)
        log(f"[scene] {n_tris} triangles, {accel.num_blocks} blocks, builder "
            f"{accel.builder}, built in {time.perf_counter() - t0:.2f} s")
        results = kernel_phase(scene, camera, accel, device)
        parity_phase()
        counts, ms_spp, rays_s = main_path_phase(scene, camera, device)

    kernel_rows = [{
        "name": f"{k} {NAMES[k]}", "route": "cuda",
        "source": "mcrt_tpu_torch/csrc/blocked.cu", "replaces": REPLACES[k],
        "launches": counts[k], "max_abs_err": results[k]["max_abs_err"],
        "ms": results[k]["ms"][-1], "plain_ms": results[k]["plain_ms"][-1],
    } for k in NAMES]
    log(f"[main] card: {card_line()}; {ms_spp:.2f} ms/spp, {rays_s:.4e} rays/s")
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
