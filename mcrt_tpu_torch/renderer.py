"""Frame renderer (counterpart of ``mcrt_tpu/renderer.py``).

``render_sample`` traces one sample per pixel: the frame-wide Halton jitter,
pinhole rays in Morton pixel order, a per-pixel sample stream and the
integrator (the path tracer or BDPT), then the radiance back in row-major
pixel order.  ``render_sample`` runs with autograd on: both integrators
are differentiable with respect to the scene's tensors (inverse rendering,
``diff/``).
``render_frame_fn`` folds ``samples_per_pass`` such samples into the
accumulator, and ``Renderer`` owns the scene, the intersector and the
accumulator on one device; its ``display_image`` applies the optional
denoise and tone map.  PyTorch runs eagerly, so where the JAX package
jits one program per frame this is a Python loop over the bounces.  The
``Renderer``'s own frames on a card, under the path tracer with the Sobol
sampler, replay each bounce's shading as a CUDA graph that it owns
(``integrators.path.ShadeGraphs``) from the second frame of a scene on;
the queries between them, a scene's first frame, and every other caller
of ``render_sample``, run eagerly.
"""
from __future__ import annotations

import functools
import time as _time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .accel import Intersector, build_intersector
from .camera.pinhole import PinholeCamera, pixel_uv
from .config import IntegratorType, RenderConfig
from .core.types import Rays, default_device, from_host
from .film.accumulate import Accumulator, accumulate
from .film.denoise import bilateral
from .film.tonemap import reinhard
from .integrators import bdpt as bdpt_integrator
from .integrators import path as path_integrator
from .sampling import rng
from .scene.scene import Scene
from .utils.profiling import span


def _radical_inverse(i: int, base: int) -> np.float32:
    """Halton radical inverse in float32, in the JAX package's order of
    operations (32 digits), so the result is bit-equal to it.  XLA turns
    ``inv / base`` into a multiply by the float32 reciprocal of the
    constant base, so that is what is computed here."""
    val, inv = np.float32(0.0), np.float32(1.0)
    recip = np.float32(1.0) / np.float32(base)
    for _ in range(32):
        d = i % base
        i //= base
        inv = np.float32(inv * recip)
        val = np.float32(val + np.float32(d) * inv)
    return val


def frame_jitter(frame: int, device=None) -> torch.Tensor:
    """(2,) sub-pixel offset in [-0.5, 0.5) for this frame."""
    device = default_device(device)
    f = int(frame)
    half = np.float32(0.5)
    jit = np.asarray([_radical_inverse(f + 1, 2) - half,
                      _radical_inverse(f + 1, 3) - half], np.float32)
    return from_host(torch.from_numpy(jit), device)


@functools.lru_cache(maxsize=8)
def morton_pixel_order(w: int, h: int):
    """2D Morton pixel permutation and its inverse (numpy int32): rays are
    traced in Z-order so each intersector tile covers a compact screen
    square."""
    xs = np.arange(w * h, dtype=np.uint64) % w
    ys = np.arange(w * h, dtype=np.uint64) // w

    def expand(x):
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x33333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x55555555)
        return x

    code = (expand(xs) << np.uint64(1)) | expand(ys)
    order = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(w * h, dtype=np.int32)
    return order, inv


@functools.lru_cache(maxsize=8)
def _pixel_order_tensors(w: int, h: int, device: torch.device):
    order, inv = morton_pixel_order(w, h)
    return (torch.from_numpy(order).to(device),
            torch.from_numpy(inv).long().to(device))


def slot_pixels(w: int, h: int, device, lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """(hi - lo,) long: the row-major pixel that each of the trace slots
    lo..hi carries (all of them by default)."""
    return _pixel_order_tensors(w, h, device)[0][lo:hi].long()


class SlotSlice(NamedTuple):
    """One rank's share of a rays-sharded render: trace slots lo..hi of
    the Morton-ordered wavefront, and ``reduce_film``, which sums an
    (H*W, 3) film over the ranks that trace the other slots (BDPT's t=1
    splats of a slice land on every rank's pixels)."""

    lo: int
    hi: int
    reduce_film: Callable[[torch.Tensor], torch.Tensor]


def render_sample(scene: Scene, camera: PinholeCamera, frame: int,
                  cfg: RenderConfig, intersector: Intersector,
                  share: SlotSlice | None = None):
    """One sample-per-pixel wavefront: ((H*W, 3) radiance in row-major pixel
    order, (2,) jitter used).  Differentiable under either integrator.

    With ``share`` only its trace slots are traced, and the radiance is
    theirs, in slot order (``slot_pixels`` gives their pixels).  Sample
    streams are keyed by the pixel (Sobol) and
    by the full wavefront's row (RANDOM), so each traced pixel gets the
    radiance it gets in the full render."""
    w, h = cfg.width, cfg.height
    device = camera.position.device
    with span("mcrt.camera"):
        jitter = frame_jitter(frame, device)
        _, inv_order = _pixel_order_tensors(w, h, device)
        lo, hi = (0, w * h) if share is None else (share.lo, share.hi)
        traced = slot_pixels(w, h, device, lo, hi)
        uv = pixel_uv(w, h, jitter=jitter[None, :], device=device)[traced]
        o, d = camera.generate_rays(uv)
        diff = camera.generate_ray_differentials(uv, w, h)
        rays = Rays.make(o, d)
        # per-pixel sample streams stay keyed by the pixel, not the trace slot
        stream = rng.make_stream(cfg.sampler, frame, traced, row0=lo)
    if cfg.integrator.type == IntegratorType.PATH:
        radiance = path_integrator.trace(scene, rays, stream, cfg.integrator,
                                         intersector.intersect, intersector.occluded,
                                         diff=diff)
    else:
        radiance = bdpt_integrator.trace(scene, camera, rays, stream, cfg.integrator,
                                         intersector.intersect, intersector.occluded,
                                         film=(w, h), slot_of_pixel=inv_order, share=share)
    if share is not None:
        return radiance, jitter
    return radiance[inv_order], jitter


def render_frame_fn(scene: Scene, camera: PinholeCamera, accum: Accumulator,
                    frame: int, cfg: RenderConfig,
                    intersector: Intersector) -> Accumulator:
    """One progressive frame: ``samples_per_pass`` samples folded into the
    accumulator (``frame`` is the number of samples already accumulated)."""
    with span("mcrt.frame"):
        for i in range(cfg.samples_per_pass):
            radiance, jitter = render_sample(scene, camera, frame + i, cfg, intersector)
            with span("mcrt.film"):
                accum = accumulate(accum, radiance, jitter, cfg.filter,
                                   cfg.integrator.max_radiance)
    return accum


class Renderer:
    """Host-side orchestrator: owns the scene and camera on ``device`` (the
    CUDA card unless the caller names another), the intersector (built
    once), the accumulator and the shading's CUDA graphs
    (``path_integrator.ShadeGraphs``, which the path tracer replays inside
    ``step``)."""

    def __init__(self, scene: Scene, camera: PinholeCamera, cfg: RenderConfig,
                 device=None):
        self.device = default_device(device)
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.cfg = cfg
        self.intersector = build_intersector(self.scene, cfg)
        self.accum = Accumulator.zeros(cfg.width, cfg.height, self.device)
        self._render_start = None
        self._shade_graphs = path_integrator.ShadeGraphs()

    def shade_graph_stats(self) -> dict[str, int]:
        """The shading graphs' host counters: ``captures``, ``replays`` and
        ``eager_bounces`` (bounces of this renderer's frames that ran
        eagerly: off a card, under RANDOM, or in the first frame of a scene
        or config)."""
        return self._shade_graphs.stats()

    def reset(self):
        """Accumulation reset on a camera move or scene edit."""
        self.accum = self.accum.reset()
        self._render_start = None

    def update_scene(self, scene: Scene, rebuild_accel: bool = True):
        """Swap in an edited scene, refit or rebuild the accel, and reset
        the accumulation.  The edit is read from tensor identity, as in
        the JAX package: a scene that shares the current ``indices`` and
        ``face_valid`` tensors (``SceneAnimator.transformed``,
        ``Scene.replace``) has moved vertices over the same faces, so a
        blocked accel is refitted (``refit_blocked``); a two-level accel is
        refitted when the ``positions`` are shared too, an instance-only
        edit (``set_shape_transform``, ``refit_two_level_scene``); any
        other edit rebuilds on the host.  A refit runs on the scene's
        device and makes no host sync.  ``rebuild_accel=False`` keeps the
        intersector as it is, for an edit that leaves the geometry alone
        (materials, lights).  The shading graphs are dropped: the next frame
        runs eagerly, and they are captured anew if the frame after it
        renders the same scene."""
        from .accel import blocked_intersector, two_level_intersector
        from .accel.blocked import BlockedAccel, refit_blocked
        from .accel.two_level import TwoLevelAccel, refit_two_level_scene

        old, scene = self.scene.geometry, scene.to(self.device)  # keeps tensors on the device
        self.scene = scene
        if rebuild_accel:
            acc, geom = self.intersector.accel, scene.geometry
            same_faces = geom.indices is old.indices and geom.face_valid is old.face_valid
            if isinstance(acc, BlockedAccel) and same_faces:
                self.intersector = blocked_intersector(refit_blocked(acc, geom))
            elif (isinstance(acc, TwoLevelAccel) and same_faces
                  and geom.positions is old.positions):
                self.intersector = two_level_intersector(refit_two_level_scene(acc, scene))
            else:
                self.intersector = build_intersector(scene, self.cfg)
        self._shade_graphs.clear()
        self.reset()

    def update_camera(self, camera: PinholeCamera):
        self.camera = camera.to(self.device)
        self.reset()

    def step(self, n_frames: int = 1) -> Accumulator:
        with torch.no_grad(), path_integrator.replaying(self._shade_graphs):
            for _ in range(n_frames):
                if self.stopped():
                    break
                self.accum = render_frame_fn(self.scene, self.camera, self.accum,
                                             self.accum.frame, self.cfg,
                                             self.intersector)
        return self.accum

    def stopped(self) -> bool:
        """Pause conditions: ``stop_at_spp`` samples or ``stop_at_time_s``."""
        if self.cfg.stop_at_spp and self.accum.frame >= self.cfg.stop_at_spp:
            return True
        if self.cfg.stop_at_time_s:
            if self._render_start is None:
                self._render_start = _time.monotonic()
            elif _time.monotonic() - self._render_start >= self.cfg.stop_at_time_s:
                return True
        return False

    def render(self, spp: int | None = None) -> torch.Tensor:
        """Render to ``spp`` samples per pixel; returns the resolved image."""
        spp = spp if spp is not None else self.cfg.spp
        self.step(-(-spp // self.cfg.samples_per_pass))
        return self.display_image()

    def display_image(self) -> torch.Tensor:
        """The resolved (H, W, 3) image (rows bottom-up, as in the JAX
        package), then the bilateral denoise and the Reinhard tone map
        where the config enables them."""
        img = self.accum.image
        if self.cfg.denoise.enabled:
            img = bilateral(img, self.cfg.denoise)
        if self.cfg.tonemap.enabled:
            img = reinhard(img, self.cfg.tonemap)
        return img
