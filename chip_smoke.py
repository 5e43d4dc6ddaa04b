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
8. Multi-GPU (``parallel/``), each phase with the launch counters set to
   0 just before and read just after.  A one-rank NCCL group started by
   the port's own ``parallel.mesh.init_process_group`` and
   ``make_mesh()`` (NCCL takes one rank a card, so one card gives world
   size 1).  ``[mesh_render]``: ``make_sharded_render`` on
   ``sphere_field`` at 512x512, depth 8, ``MESH_FRAMES`` samples against
   ``render_spp_batch`` without a mesh, equal (or, where the spp mean's
   order differs, within rtol 1e-6, said so), both timed in turns.
   ``[mesh_grad]``: the sharded ``make_train_step`` against the
   unsharded one at ``[grad]``'s configuration: the loss within rtol
   1e-6, the gradients within ``grad_check.GRAD_TOL``.  ``[ring1]``:
   ``build_sharded_scene(sphere_field)`` (one shard) rendered through the
   ring at 512x512, depth 8: its mean against the unsharded one at the
   parity share, one sample under the sync check, then every K1 launch of
   one sample equal to ``cull_plain`` and every K2/K3 launch within the
   walks' tolerance.  ``[ring4]``: ``shard_faces`` and
   ``_build_shard_accels`` of ``sphere_field`` at n = 4, the ring's own
   steps (``closest_step``, ``occluded_step``) over the four shards in
   ring order on the primary and bounce wavefronts, against the
   unsharded queries (hit flags within the walks' tolerance, t at rtol
   1e-5 where both hit), each shard's query time and their sum beside
   the unsharded query's, then every K1-K3 launch of the four steps
   against the plain versions.  ``[mesh_multi]``: with two cards or
   more, min(4, count) NCCL ranks run the ring render and the sharded
   render and step against rank 0's single-card results; with one card
   it prints that it waits.
9. ``[cli]``: ``python -m mcrt_tpu_torch info`` as a subprocess (it must
   name the card and its memory); ``render --scene textured_hall`` at
   512x512, ``CLI_SPP`` spp, depth 8 (exit 0, its wall time and the
   Mrays/s it prints), its PNG decoded by ``decode_png`` against
   ``to_srgb_u8`` of an in-process ``Renderer`` render of the same
   configuration (0.99 of pixels within 1 level), the same command with
   ``--progressive CLI_PROGRESSIVE`` (it must write twice); then the tone
   map and the bilateral denoiser at 512x512 on the card, each timed,
   against the same formulas on the CPU from the same resolved image
   (rtol 1e-5 / atol 1e-6).  Then ``view`` as a subprocess (``cornell_box``
   512x512, depth 8, port 0): its address read from its first line, its
   status polled until ``VIEW_SPP`` samples, ``/image.png`` fetched and
   decoded once, then SIGINT: it must exit 0.
10. BDPT gradients, outside ``torch.no_grad()``, each phase with the
   launch counters set to 0 just before and read just after, as phase 7's
   (``grad_phase`` under BDPT: the forward loss without a graph and the
   step timed ``GRAD_STEPS`` times each, their ratio, the peak memory, the
   gradients finite and not all zero, the step's loss the forward's):
   ``[bdpt_grad]`` (``sphere_field`` 512x512, depth 8, 1 spp,
   ``full_params``; K1-K3), ``[bdpt_grad_128]`` (128x128, depth 3, 2 spp,
   ``material_params``), ``[bdpt_grad_dense]`` (``cornell_box``; K4/K5),
   ``[bdpt_grad_instanced]`` (``sphere_field_instanced``, depth 3; K1, K6,
   K7); each 512x512 phase then runs one step more per kernel group and
   holds every launch against the plain versions, as phase 6 holds a
   frame's (a full occlusion chunk of 2^21 rays among them).
   ``[bdpt_grad_parity]``: card BDPT gradients against CPU BDPT gradients
   (``tools/grad_check.py``) on ``cornell_box`` (material and light
   parameters, 16x16, 16 spp) and ``glass_gallery`` (materials, 12x12, 4
   spp), depth 2, within ``GRAD_TOL``.  Phase 8's ``[mesh_grad]`` also runs
   under BDPT (``[mesh_grad_bdpt]``).
11. The product surface, each phase with the launch counters around it.
   ``[viewer]``: ``ProgressiveViewer`` on ``cornell_box`` 512x512, depth 8
   (K4/K5), port 0: frames of ``serve`` (ms/spp), the page, the PNG, the
   status and the stats (the card's memory); an edit of each kind through
   HTTP (orbit, material, light, transform, the switch to
   ``glass_gallery``, K1-K3), each resetting the spp and changing the
   image, the material and light edits keeping the intersector, the
   transform refitting it; a pick at the centre against the CPU's, and one
   over HTTP answered by the render loop; one frame of each path holding
   every launch against the plain versions.  ``[checkpoint]``:
   ``textured_hall`` 512x512 rendered, saved, loaded into a fresh
   ``Renderer`` and rendered on, equal bit for bit to the uninterrupted
   render; a ``full_params`` tree saved and restored.  ``[profiler]``:
   ``utils/profiling.py`` spans around 2 synced frames under
   ``device_trace``: the report printed, the trace file holding the spans.
12. The LBVH and the brute-force oracle (``AccelType.LBVH``/``BRUTE``,
   plain PyTorch on the card), each phase with the launch counters set to
   0 just before the LBVH's or the oracle's work and read just after: K1-K7
   must read 0, so the accel choice was honoured.  ``[lbvh]``
   (``sphere_field``, leaf size 2): the build's card time, fixpoint steps
   and host syncs; on phase 2's 512x512 primary and bounce wavefronts the
   closest-hit and occlusion queries' times, loop iterations and host syncs
   (one every ``traverse.SYNC_EVERY`` = 8 iterations), and
   ``traversal_iterations``' lockstep count and visits; one warm and
   ``LBVH_FRAMES`` timed 512x512, depth-8 frames through ``Renderer`` and
   one more with its synchronizing calls counted; the card's build equal
   to a CPU build field for field; the hits against the blocked queries'
   (K1-K3) under ``tests/test_lbvh.py``'s rules (flags equal, t at rtol
   1e-5 / atol 1e-6, prim ids on more than 97% of hits, occlusion equal),
   where a ray may differ only as the list walks may differ from their
   plain versions (``walk_allowed``) and only if the oracle agrees with
   the LBVH on it.  ``[brute]``: the oracle against K4/K5's queries on
   ``textured_hall``'s full 512x512 wavefronts and against the LBVH on
   ``ORACLE_RAYS`` = 4,096 rays of ``sphere_field``'s (both exactly, at
   those rules), against K1-K3 there and against K6/K7 on 4,096 rays of
   ``sphere_field_instanced`` through its baked world-space faces (within
   ``walk_allowed``; K6/K7 at rtol 2e-4 / atol 2e-4 and shape ids on 99%,
   ``tests/test_two_level.py``'s bounds for the bake's rounding); one
   ``cornell_box`` frame (512x512, depth 8) with ``accel=BRUTE`` under the
   sync check against the ``AUTO`` (K4/K5) frame of the same streams at the
   parity share; every query time beside its reference's.
   ``[ring4_brute]``: ``[ring4]``'s four shards with the ring's brute
   variant (``use_blocked=False``), its steps in ring order in one process
   on 64x64 wavefronts, against the blocked ring's steps under the same
   rules; both times printed.
13. The three ``bunny.obj`` scenes, each phase with the launch counters
   set to 0 just before and read just after.  ``bunny.obj`` is not in the
   repository, so the phase writes a stand-in into a temporary directory
   (``write_standin_obj``: an icosphere of 5,120 triangles moved along its
   normals by low-frequency sinusoids), once with ``vn``/``vt`` and once
   with positions alone (the loader then computes the normals, which must
   match the other file's), and passes it as ``bunny_path``; at the
   builders' default grids that is their full size.  ``[bunny_field]``
   (250,882 triangles; the file without normals) and ``[heavy_gallery]``
   (184,324; all four light types, a textured and normal-mapped floor,
   mirror and glass) as phase 4's main paths, 512x512, 8 bounces, K1-K3
   and none of K4-K7, each with one more frame holding every K1 launch
   (keys equal) and one more every K2/K3 launch (the walks' tolerance);
   ``[heavy_gallery_sbvh]``, whose image must lie within
   ``tests/test_heavy_golden.py``'s 0.02 mean-relative of the SAH image
   and agree with it on ``PARITY_MIN_SHARE`` of pixels; ``[heavy_gallery_bdpt]`` (BDPT, 128x128,
   depth 3, as ``[bdpt_128]``); ``[bunny_field_instanced]`` (one BLAS in 48
   instances; K1, K6, K7 and none of K2-K5; every K1 and K6/K7 launch of
   one more frame held); ``[loop_oracle]``: the stand-in in
   ``tests/test_two_level.py``'s 100-instance grid, ``LOOP_RAYS`` =
   262,144 random rays (numpy seed 7) through K6/K7 and through the
   per-instance loop of flat queries (``intersect_two_level_loop``, K2 and
   K3 once an instance) under that test's criteria (valid flags equal, t
   within rtol 1e-5 / atol 1e-5, occluded flags equal), then the same rays
   through ``bunny_field_instanced``'s accel unsorted against sorted,
   alike; and ``heavy_gallery`` at grid 2 card against CPU as phase 3.
14. ``[api]``: the JAX package's public names that touch the card, called
   as a caller of ``mcrt_tpu`` would, with no device given and the launch
   counters set to 0 just before and read just after (they must stay 0):
   ``Hit.none(4096)``, ``Accumulator.zeros(512, 512)`` and
   ``sampling.sobol.sobol_matrices()`` must land on ``cuda``
   (``Hit.none``'s fields the misses'); ``runtime.
   device_memory_stats(index=0)`` must have its four keys and its
   ``bytes_limit`` ``torch.cuda.mem_get_info(0)[1]``;
   ``runtime.enumerate_devices()`` must name every card;
   ``runtime.native.get_lib()`` must load the native library; and
   ``runtime.buffers.register("scene", ...)`` of phase 2's ``sphere_field``
   must count its ``nbytes`` (then released).  One line prints these
   facts.

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
phase's count of phases 4 to 14; each row's ``variants`` map holds
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


def parity_phase(name: str, sampler: str = "SOBOL", integrator: str = "PATH",
                 builder_kw: dict | None = None):
    """``name``'s builder (with ``builder_kw``) rendered at 64x64, 1 spp,
    depth 3 on the card and on the CPU: at least ``PARITY_MIN_SHARE`` of
    pixels must agree."""
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
        scene, camera = getattr(builders, name)(device=dev, **(builder_kw or {}))
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
    pairs = f", {accel.num_pairs} (instance, block) pairs" if blocks is not accel else ""
    log(f"[{label}] accel {type(accel).__name__} build {time.perf_counter() - t0:.2f} s, "
        f"builder {blocks.builder}, {blocks.num_blocks} blocks{pairs}, "
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
    renderer.step(1)  # the shading graphs' capture frame (Renderer's second)
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
               spp=1, depth=MAX_DEPTH, frame_phases=(), integrator="PATH"):
    """A gradient step (``make_train_step``, the mean squared error against
    a render of other samples) on ``scene`` at ``size``^2, Sobol, ``depth``
    bounces, ``spp`` samples, under ``integrator``, with ``view_name``'s parameters: the forward
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

    cfg = main_cfg(spp=spp, size=size, depth=depth, integrator=integrator)
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
    log(f"[{label}] {size}x{size}, {depth} bounces, {spp} spp, {integrator.lower()}, "
        f"{view_name}: forward "
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


BDPT_GRAD_PHASES = ("bdpt_grad", "bdpt_grad_128", "bdpt_grad_dense", "bdpt_grad_instanced",
                    "bdpt_grad_parity")


def bdpt_grad_parity_phase(device):
    """Card BDPT gradients against CPU BDPT gradients
    (``tools/grad_check.py``) over the (sample, pixel) pairs whose forward
    radiance agrees (at least 99%), each field within ``GRAD_TOL``:
    ``cornell_box`` ``material_params`` and ``light_params`` (16x16, 16
    spp, depth 2; K4/K5) and ``glass_gallery`` ``material_params`` (12x12,
    4 spp, depth 2; K1-K3)."""
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.scene.builders import cornell_box, glass_gallery
    from mcrt_tpu_torch.tools import grad_check

    label = "bdpt_grad_parity"
    kernels.reset_launch_counts()
    for builder, view, size, spp in ((cornell_box, "material_params", 16, 16),
                                     (cornell_box, "light_params", 16, 16),
                                     (glass_gallery, "material_params", 12, 4)):
        share, grads = grad_check.device_parity(builder, view, size, spp, 2, device,
                                                integrator="BDPT")
        cmp = grad_check.compare(grads)
        log(f"[{label}] {builder.__name__} {view}: samples agreeing {share:.4f}; " + ", ".join(
            f"{k} max |card - cpu| {e:.3e} of max |g| {sc:.4e} ({'within' if ok else 'OUTSIDE'}"
            f" rtol {grad_check.GRAD_TOL[k][0]:g} + {grad_check.GRAD_TOL[k][1]:g} max)"
            for k, (e, sc, ok) in cmp.items()))
        if share < grad_check.MIN_AGREE or not all(ok for _, _, ok in cmp.values()):
            raise AssertionError(f"{label}: {builder.__name__} {view}: card BDPT gradients "
                                 "depart from the CPU's")
    counts = kernels.launch_counts()
    check_launches(label, counts, ("K1", "K2", "K3", "K4", "K5"), ("K6", "K7"))
    return counts


def bdpt_grad_phases(scene, camera, device):
    """Phase 10, BDPT gradients, outside ``torch.no_grad()``: ``grad_phase``
    under BDPT on ``sphere_field`` at 512x512, depth 8 (K1-K3) and at
    128x128, depth 3, 2 spp; ``cornell_box`` at 512x512, depth 8 (K4/K5);
    ``sphere_field_instanced`` at 512x512, depth 3 (K1, K6, K7); each
    512x512 phase holds every launch of its kernels on one more step
    against the plain versions, a full occlusion chunk among them; then
    ``[bdpt_grad_parity]``.  Returns each phase's launch counts."""
    from mcrt_tpu_torch.scene.builders import cornell_box, sphere_field_instanced

    k1_3, k4_5, k6_7 = ("K1", "K2", "K3"), ("K4", "K5"), ("K6", "K7")
    cull = partial(cull_frame_phase, chunk=True)
    every = ("diffuse", "roughness", "intensity")
    return {
        "bdpt_grad": grad_phase(
            "bdpt_grad", scene, camera, device, "full_params", k1_3, k4_5 + k6_7, every,
            integrator="BDPT",
            frame_phases=(cull, partial(walk_frame_phase, ids=("K2", "K3"), chunk="K3")))[0],
        "bdpt_grad_128": grad_phase(
            "bdpt_grad_128", scene, camera, device, "material_params", k1_3, k4_5 + k6_7,
            ("diffuse", "roughness"), size=128, spp=2, depth=3, integrator="BDPT")[0],
        "bdpt_grad_dense": grad_phase(
            "bdpt_grad_dense", *cornell_box(device=device), device, "full_params", k4_5,
            k1_3 + k6_7, ("diffuse", "intensity"), integrator="BDPT",
            frame_phases=(partial(dense_frame_phase, chunk=True),))[0],
        "bdpt_grad_instanced": grad_phase(
            "bdpt_grad_instanced", *sphere_field_instanced(device=device), device,
            "full_params", ("K1",) + k6_7, ("K2", "K3") + k4_5, every, depth=3,
            integrator="BDPT",
            frame_phases=(cull, partial(walk_frame_phase, ids=k6_7, chunk="K7")))[0],
        "bdpt_grad_parity": bdpt_grad_parity_phase(device),
    }


MESH_FRAMES = 4  # samples of [mesh_render] and [ring1]
RING_SHARDS = 4  # shards of [ring4], run in ring order in one process
CLI_SPP, CLI_PROGRESSIVE = 8, 4  # [cli]: samples, and the interval of its progressive run


def mesh_render_phase(scene, camera, mesh, device):
    """``[mesh_render]``: ``make_sharded_render`` over the one-rank mesh
    against ``render_spp_batch`` without a mesh (``sphere_field`` 512x512,
    depth 8, ``MESH_FRAMES`` samples), timed in turns (unsharded, sharded,
    sharded, unsharded) after one sharded warm-up call, with the launch
    counters around one sharded call.
    Returns (launch counts, the unsharded mean)."""
    import torch

    from mcrt_tpu_torch.accel import build_intersector, kernels
    from mcrt_tpu_torch.parallel.render import make_sharded_render, render_spp_batch
    from mcrt_tpu_torch.tools.card import card_line

    label = "mesh_render"
    cfg = main_cfg(spp=MESH_FRAMES)
    isect = build_intersector(scene, cfg)
    frames = list(range(MESH_FRAMES))
    fn = make_sharded_render(scene, camera, cfg, isect, mesh)
    fn(scene, frames)  # warm-up: the first collectives start the group's communicators
    ref_ms, _, ref = timed(lambda: render_spp_batch(scene, camera, frames, cfg, isect), 1)
    kernels.reset_launch_counts()
    sh_ms, _, img = timed(lambda: fn(scene, frames), 1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    sh_ms2, _, img2 = timed(lambda: fn(scene, frames), 1)
    ref_ms2, _, _ = timed(lambda: render_spp_batch(scene, camera, frames, cfg, isect), 1)
    check_launches(label, counts, ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7"))
    equal = torch.equal(img, ref) and torch.equal(img2, ref)
    close = all(torch.allclose(x, ref, rtol=1e-6, atol=0.0) for x in (img, img2))
    log(f"[{label}] mesh {tuple(mesh.mesh.shape)}, {WIDTH}x{HEIGHT}, {MAX_DEPTH} bounces, "
        f"{MESH_FRAMES} samples: sharded {sh_ms:.2f} / {sh_ms2:.2f} ms, unsharded "
        f"{ref_ms:.2f} / {ref_ms2:.2f} ms (in turns: unsharded, sharded, sharded, "
        f"unsharded); overhead {(sh_ms + sh_ms2) / (ref_ms + ref_ms2) - 1.0:+.4f}; equal to "
        f"the unsharded mean: {equal}"
        + ("" if equal else f", within rtol 1e-6: {close} (the spp mean's order differs)")
        + f"; launches {counts}; card {card_line()}")
    if not (equal or close):
        raise AssertionError(f"{label}: the sharded render departs from the unsharded one")
    return counts, ref


def mesh_grad_phase(scene, camera, mesh, device, integrator="PATH"):
    """``[mesh_grad]``: the sharded ``make_train_step`` over the one-rank
    mesh against the unsharded step at ``[grad]``'s configuration
    (``sphere_field`` 512x512, depth 8, 1 spp, ``full_params``): the loss
    within rtol 1e-6, every gradient within ``grad_check.GRAD_TOL``; both
    steps timed in turns after one sharded warm-up step.  Under BDPT,
    ``[mesh_grad_bdpt]``, at ``[bdpt_grad]``'s configuration."""
    import torch

    from mcrt_tpu_torch.accel import build_intersector, kernels
    from mcrt_tpu_torch.diff import estimators
    from mcrt_tpu_torch.parallel.render import make_train_step, render_spp_batch
    from mcrt_tpu_torch.tools import grad_check
    from mcrt_tpu_torch.tools.card import card_line

    label = "mesh_grad" if integrator == "PATH" else "mesh_grad_bdpt"
    cfg = main_cfg(spp=1, integrator=integrator)
    isect = build_intersector(scene, cfg)
    view = estimators.full_params()
    with torch.no_grad():
        target = render_spp_batch(scene, camera, [1000], cfg, isect)
    plain = make_train_step(camera, cfg, isect, None, view.get, view.set)
    sharded = make_train_step(camera, cfg, isect, mesh, view.get, view.set)
    sharded(scene, [0], target)  # warm-up, as in [mesh_render]
    ref_ms, _, (loss0, g0) = timed(lambda: plain(scene, [0], target), 1)
    kernels.reset_launch_counts()
    sh_ms, _, (loss, g) = timed(lambda: sharded(scene, [0], target), 1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    sh_ms2, _, _ = timed(lambda: sharded(scene, [0], target), 1)
    ref_ms2, _, _ = timed(lambda: plain(scene, [0], target), 1)
    check_launches(label, counts, ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7"))
    check_grads(label, g, ("diffuse", "roughness", "intensity"))
    worst = []
    for k, ref in g0.items():
        rtol, atol = grad_check.GRAD_TOL[k]
        scale = ref.abs().max().item()
        err = (g[k] - ref).abs()
        ok = bool((err <= rtol * ref.abs() + atol * scale).all())
        worst.append(f"{k} max |sharded - unsharded| {err.max().item():.3e} of max |g| "
                     f"{scale:.4e} ({'within' if ok else 'OUTSIDE'} rtol {rtol:g} + {atol:g} max)")
        if not ok:
            raise AssertionError(f"{label}: the sharded step's {k} gradient departs")
    loss_ok = bool(torch.isclose(loss, loss0, rtol=1e-6, atol=0.0))
    log(f"[{label}] {WIDTH}x{HEIGHT}, {MAX_DEPTH} bounces, 1 spp, {integrator.lower()}, "
        f"full_params: sharded step "
        f"{sh_ms:.2f} / {sh_ms2:.2f} ms, unsharded {ref_ms:.2f} / {ref_ms2:.2f} ms (in turns); "
        f"loss {loss.item():.6e} against {loss0.item():.6e} (rtol 1e-6: {loss_ok}); "
        + "; ".join(worst) + f"; launches {counts}; card {card_line()}")
    if not loss_ok:
        raise AssertionError(f"{label}: the sharded loss departs from the unsharded one")
    return counts


def ring1_phase(scene, camera, mesh, device, ref):
    """``[ring1]``: ``build_sharded_scene(sphere_field)`` on the one-rank
    mesh (one shard: every face, reordered by its Morton key, in one blocked
    accel), rendered by ``render_spp_batch`` over the mesh at 512x512,
    depth 8, ``MESH_FRAMES`` samples with the launch counters around it;
    the mean against the unsharded one at the parity share; one more
    sample under the sync check; then one sample more for each kernel
    group holds every K1-K3 launch against the plain versions."""
    import torch

    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.parallel.render import render_spp_batch
    from mcrt_tpu_torch.parallel.ring import build_sharded_scene
    from mcrt_tpu_torch.renderer import render_sample
    from mcrt_tpu_torch.tools.card import card_line

    label = "ring1"
    cfg = main_cfg(spp=MESH_FRAMES)
    t0 = time.perf_counter()
    sscene, ring = build_sharded_scene(scene, mesh)
    build_s = time.perf_counter() - t0
    frames = list(range(MESH_FRAMES))
    kernels.reset_launch_counts()
    ms, _, img = timed(lambda: render_spp_batch(sscene, camera, frames, cfg, ring, mesh), 1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_launches(label, counts, ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7"))
    log(f"[{label}] one shard of {ring.accel.num_blocks} blocks, built in {build_s:.2f} s; "
        f"{MESH_FRAMES} samples {ms:.2f} ms ({ms / MESH_FRAMES:.2f} ms/spp), launches "
        f"{counts}; card {card_line()}")
    img, ref = img.reshape(-1, 3), ref.reshape(-1, 3)
    if not bool(torch.isfinite(img).all()) or not img.mean().item() > 0.0:
        raise AssertionError(f"{label}: image not finite/positive")
    agreement(label, "the ring's mean against the unsharded mean", img, ref)
    frame = partial(render_sample, sscene, camera, MESH_FRAMES, cfg, ring)
    frames_timed(label, [frame])
    cull_frame_phase(frame, label)
    walk_frame_phase(frame, label, ids=("K2", "K3"))
    return counts


def ring4_phase(scene, camera, device):
    """``[ring4]``: the 4-shard ring in one process.  ``shard_faces`` and
    ``_build_shard_accels`` of ``sphere_field`` at n = 4 (every shard's
    tables on the card); on the 512x512 primary and bounce wavefronts, the
    ring's own steps (``closest_step``, ``occluded_step``) over the four
    shards in ring order, after the one coherence sort with the global
    bounds, against the unsharded ``intersect_blocked`` /
    ``occluded_blocked`` on the same rays: hit flags within the walks'
    tolerance and t at rtol 1e-5 where both hit.  Each shard's query time,
    their sum and the unsharded query's time are printed; one more run of
    the four steps holds every K1-K3 launch against the plain versions.
    Returns the launch counts of one untimed pass of the four steps on
    each wavefront, read with nothing else in between."""
    import torch

    from mcrt_tpu_torch.accel import build_intersector, kernels
    from mcrt_tpu_torch.accel.blocked import _coherence_order
    from mcrt_tpu_torch.core.types import Hit
    from mcrt_tpu_torch.parallel.ring import (_build_shard_accels, _take, _unsort,
                                              closest_step, occluded_step, shard_faces)
    from mcrt_tpu_torch.tools.card import card_line
    from mcrt_tpu_torch.tools.wavefronts import wavefronts

    label = "ring4"
    t0 = time.perf_counter()
    geom, _ = shard_faces(scene.geometry, RING_SHARDS, return_face_map=True)
    fpad = geom.indices.shape[0] // RING_SHARDS
    acc = _build_shard_accels(geom, RING_SHARDS, fpad, device=device)
    log(f"[{label}] {RING_SHARDS} shards of {fpad} faces, {acc.num_blocks} blocks each "
        f"(padded; real blocks {[int((a[:, 0] == a[:, 0]).sum()) for a in acc.aabb]}), built "
        f"in {time.perf_counter() - t0:.2f} s")
    whole = build_intersector(scene, main_cfg())
    wfs = wavefronts(camera, lambda r: whole.intersect(scene, r), device)

    def ring_closest(rays, order, each=None):
        rays_s, best = _take(rays, order), Hit.none(rays.n, device)
        for s in range(RING_SHARDS):
            if each is None:
                best = closest_step(geom, acc, s, fpad, rays_s, best)
            else:
                ms, _, best = timed(partial(closest_step, geom, acc, s, fpad, rays_s, best),
                                    KERNEL_REPS)
                each.append(ms)
        return _unsort(best, order)

    def ring_occluded(rays, order, each=None):
        rays_s = _take(rays, order)
        blocked = torch.zeros((rays.n,), dtype=torch.bool, device=device)
        for s in range(RING_SHARDS):
            if each is None:
                rays_s, blocked = occluded_step(geom, acc, s, fpad, rays_s, blocked)
            else:
                ms, _, (rays_s, blocked) = timed(
                    partial(occluded_step, geom, acc, s, fpad, rays_s, blocked), KERNEL_REPS)
                each.append(ms)
        out = torch.empty_like(blocked)
        out[order] = blocked
        return out

    orders = {wf: _coherence_order(rays, acc.bounds) for wf, rays in wfs.items()}
    kernels.reset_launch_counts()  # the ring's steps alone: one untimed pass a wavefront
    results = {wf: (ring_closest(rays, orders[wf]), ring_occluded(rays, orders[wf]))
               for wf, rays in wfs.items()}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    steps = RING_SHARDS * len(wfs)
    log(f"[{label}] launches of the ring steps, one pass on each wavefront: {counts} "
        f"(expected K1 {2 * steps}, K2 {steps}, K3 {steps}: one cull and one walk a step)")
    check_launches(label, counts, ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7"))
    if (counts["K1"], counts["K2"], counts["K3"]) != (2 * steps, steps, steps):
        raise AssertionError(f"{label}: the ring's steps launched {counts}")
    for wf, rays in wfs.items():
        order = orders[wf]
        live = rays.active
        hit, blocked = results[wf]
        times = {"closest": [], "occluded": []}
        ring_closest(rays, order, times["closest"])
        ring_occluded(rays, order, times["occluded"])
        ref_c_ms, _, ref_hit = timed(lambda: whole.intersect(scene, rays), KERNEL_REPS)
        ref_o_ms, _, ref_blocked = timed(lambda: whole.occluded(scene, rays), KERNEL_REPS)
        both = hit.valid & ref_hit.valid
        t_off = both & ~torch.isclose(hit.t, ref_hit.t, rtol=1e-5, atol=0.0)
        bad_c = (hit.valid != ref_hit.valid) | t_off
        bad_o = blocked != ref_blocked
        allowed = walk_allowed(live)
        log(f"[{label}:{wf}] closest hit: {int(hit.valid.sum())} hits (unsharded "
            f"{int(ref_hit.valid.sum())}); differing rays {int(bad_c.sum())} of "
            f"{int(live.sum())} live (flag {int((hit.valid != ref_hit.valid).sum())}, t "
            f"{int(t_off.sum())}; allowed {allowed}); shards "
            + ", ".join(f"{t:.3f}" for t in times["closest"])
            + f" ms, sum {sum(times['closest']):.3f} ms; unsharded {ref_c_ms:.3f} ms")
        log(f"[{label}:{wf}] occlusion: {int(blocked.sum())} blocked (unsharded "
            f"{int(ref_blocked.sum())}); differing rays {int(bad_o.sum())} (allowed "
            f"{allowed}); shards " + ", ".join(f"{t:.3f}" for t in times["occluded"])
            + f" ms, sum {sum(times['occluded']):.3f} ms; unsharded {ref_o_ms:.3f} ms; "
            f"card {card_line()}")
        if int(bad_c.sum()) > allowed or int(bad_o.sum()) > allowed:
            raise AssertionError(f"{label}:{wf}: the 4-shard ring departs from the "
                                 "unsharded queries")
    for wf, rays in wfs.items():
        order = _coherence_order(rays, acc.bounds)

        def steps():
            ring_closest(rays, order)
            ring_occluded(rays, order)

        cull_frame_phase(steps, f"{label}:{wf}")
        walk_frame_phase(steps, f"{label}:{wf}", ids=("K2", "K3"))
    return counts


def mesh_multi_rank(rank, results_dir):
    """One NCCL rank of ``[mesh_multi]``: ``sphere_field`` at 512x512,
    depth 8 on its own card, a (1, n) mesh; the ring render and the
    sharded render and step over it.  Rank 0 also renders and steps
    without a mesh and saves both."""
    import torch

    from mcrt_tpu_torch.accel import build_intersector
    from mcrt_tpu_torch.diff import estimators
    from mcrt_tpu_torch.parallel.mesh import make_mesh
    from mcrt_tpu_torch.parallel.render import make_train_step, render_spp_batch
    from mcrt_tpu_torch.parallel.ring import build_sharded_scene
    from mcrt_tpu_torch.scene.builders import sphere_field

    device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(device=device)
    scene, camera = sphere_field(device=device)
    cfg = main_cfg(spp=MESH_FRAMES)
    isect = build_intersector(scene, cfg)
    frames = list(range(MESH_FRAMES))
    out = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        out["sharded"] = render_spp_batch(scene, camera, frames, cfg, isect, mesh).cpu()
        out["sharded_s"] = time.perf_counter() - t0
        sscene, ring = build_sharded_scene(scene, mesh)
        t0 = time.perf_counter()
        out["ring"] = render_spp_batch(sscene, camera, frames, cfg, ring, mesh).cpu()
        out["ring_s"] = time.perf_counter() - t0
        if rank == 0:
            out["unsharded"] = render_spp_batch(scene, camera, frames, cfg, isect).cpu()
    gcfg = main_cfg(spp=1)
    gisect = build_intersector(scene, gcfg)
    view = estimators.full_params()
    with torch.no_grad():
        target = render_spp_batch(scene, camera, [1000], gcfg, gisect)
    loss, grads = make_train_step(camera, gcfg, gisect, mesh, view.get, view.set)(
        scene, [0], target)
    out["step"] = (loss.item(), {k: g.cpu() for k, g in grads.items()})
    if rank == 0:
        loss, grads = make_train_step(camera, gcfg, gisect, None, view.get, view.set)(
            scene, [0], target)
        out["step0"] = (loss.item(), {k: g.cpu() for k, g in grads.items()})
    torch.save(out, os.path.join(results_dir, f"rank{rank}.pt"))


def mesh_multi_phase(device):
    """``[mesh_multi]``: where the machine has two cards or more, min(4,
    count) NCCL ranks, one a card (``spawn_ranks``), run the ring render and
    the sharded render and step; each rank's results against rank 0's
    single-device ones (renders at the parity share, the loss at rtol 1e-5,
    gradients within ``grad_check.GRAD_TOL``).  Otherwise one line says the
    phase waits for such a machine.  Any rank's failure fails the run."""
    import tempfile

    import torch

    from mcrt_tpu_torch.parallel.mesh import spawn_ranks
    from mcrt_tpu_torch.tools import grad_check

    label = "mesh_multi"
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[{label}] waits for a machine with two cards or more: this one has {count} "
            "(NCCL takes one rank a card)")
        return
    n = min(4, count)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(mesh_multi_rank, n, args=(tmp,), device="cuda",
                    init_method=f"file://{tmp}/store", timeout=600)
        wall = time.perf_counter() - t0
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
               for r in range(n)]
    ref, (loss0, g0) = res[0]["unsharded"], res[0]["step0"]
    for r, out in enumerate(res):
        for what in ("sharded", "ring"):
            agreement(label, f"rank {r} {what} render against the single-card render",
                      out[what], ref)
        loss, g = out["step"]
        if abs(loss - loss0) > 1e-5 * abs(loss0):
            raise AssertionError(f"{label}: rank {r}'s sharded loss {loss} departs from {loss0}")
        for k, ref_g in g0.items():
            rtol, atol = grad_check.GRAD_TOL[k]
            if not bool(((g[k] - ref_g).abs() <= rtol * ref_g.abs()
                         + atol * ref_g.abs().max()).all()):
                raise AssertionError(f"{label}: rank {r}'s {k} gradient departs")
    log(f"[{label}] {n} ranks: sharded render {res[0]['sharded_s']:.2f} s, ring "
        f"render {res[0]['ring_s']:.2f} s ({MESH_FRAMES} samples, {WIDTH}x{HEIGHT}, depth 8, "
        f"first call), every rank against rank 0's single-card render and step; "
        f"{wall:.1f} s in all")


def mesh_phases(scene, camera, device):
    """Phase 8: a one-rank NCCL group started by the port's own helper and
    ``make_mesh()``; ``[mesh_render]`` and ``[ring1]`` under
    ``torch.no_grad()``, ``[mesh_grad]`` outside it; ``[ring4]`` in one
    process; ``[mesh_multi]`` where the machine has the cards.  Returns
    each phase's launch counts."""
    import tempfile

    import torch
    import torch.distributed as dist

    from mcrt_tpu_torch.parallel.mesh import init_process_group, make_mesh

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(device, f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = make_mesh(device=device)
            log(f"[mesh] one-rank {dist.get_backend()} group, mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
            with torch.no_grad():
                counts["mesh_render"], ref = mesh_render_phase(scene, camera, mesh, device)
                counts["ring1"] = ring1_phase(scene, camera, mesh, device, ref)
            counts["mesh_grad"] = mesh_grad_phase(scene, camera, mesh, device)
            counts["mesh_grad_bdpt"] = mesh_grad_phase(scene, camera, mesh, device, "BDPT")
        finally:
            dist.destroy_process_group()
    with torch.no_grad():
        counts["ring4"] = ring4_phase(scene, camera, device)
    mesh_multi_phase(device)
    return counts


VIEW_SPP = 3  # [cli]'s view: samples the subprocess reaches before it is interrupted


def view_phase(label):
    """``python -m mcrt_tpu_torch view`` (``cornell_box``, 512x512, depth 8)
    as a subprocess on port 0: the address read from its first line, its
    ``/api/status`` polled until ``VIEW_SPP`` samples, ``/image.png`` fetched
    once and decoded, then SIGINT: it must exit 0.  The subprocess is killed
    if it outlives the phase."""
    import re
    import signal
    import subprocess
    import threading

    from mcrt_tpu_torch.scene.textures import decode_png

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mcrt_tpu_torch", "view", "--scene", "cornell_box", "--port", "0",
         "--width", str(WIDTH), "--height", str(HEIGHT), "--max-depth", str(MAX_DEPTH)],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    killer = threading.Timer(300, proc.kill)
    killer.start()
    try:
        line = proc.stdout.readline()
        found = re.search(r"serving http://127\.0\.0\.1:(\d+)/", line)
        if not found:
            raise AssertionError(f"{label}: view printed {line!r}")
        port = int(found.group(1))
        served_s = time.perf_counter() - t0
        while json.loads(http_get(port, "/api/status")[1])["spp"] < VIEW_SPP:
            time.sleep(0.1)
        spp_s = time.perf_counter() - t0
        img = decode_png(http_get(port, "/image.png")[1])
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"[{label}] view subprocess: {line.strip()!r} after {served_s:.1f} s, {VIEW_SPP} spp "
        f"after {spp_s:.1f} s; /image.png {img.shape}; exit {proc.returncode} after SIGINT")
    if proc.returncode != 0 or img.shape[:2] != (HEIGHT, WIDTH):
        raise AssertionError(f"{label}: view exited {proc.returncode}:\n{out[-2000:]}{err[-3000:]}")


def cli_phase(device):
    """Phase 9, ``[cli]``: ``python -m mcrt_tpu_torch info`` and ``render``
    as subprocesses (``textured_hall``, 512x512, ``CLI_SPP`` spp, depth 8;
    then again with ``--progressive CLI_PROGRESSIVE``), and the same
    ``render`` through ``cli.main`` in this process with the launch
    counters around it; both PNGs, decoded by ``decode_png``, against
    ``to_srgb_u8`` of a ``Renderer`` render of the same configuration
    (0.99 of pixels within 1 level); then the tone map and the denoiser on
    that render's resolved image on the card against the same formulas on
    the CPU (rtol 1e-5 / atol 1e-6), each timed.  Returns the launch counts
    of the in-process CLI render."""
    import subprocess
    import tempfile

    import torch

    from mcrt_tpu_torch import Renderer, cli
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.config import DenoiseConfig, IntegratorConfig, RenderConfig, \
        ToneMapConfig
    from mcrt_tpu_torch.film.denoise import bilateral
    from mcrt_tpu_torch.film.tonemap import reinhard
    from mcrt_tpu_torch.scene.builders import textured_hall
    from mcrt_tpu_torch.scene.textures import decode_png
    from mcrt_tpu_torch.tools.card import card_line
    from mcrt_tpu_torch.utils.image import to_srgb_u8

    label = "cli"

    def run(*argv):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "mcrt_tpu_torch", *argv], cwd=HERE,
                           capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{label}: {' '.join(argv[:1])} exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
        return r.stdout, wall

    out, wall = run("info")
    name = torch.cuda.get_device_name(0)
    log(f"[{label}] info ({wall:.1f} s): " + " | ".join(out.strip().splitlines()))
    if name not in out or "memory" not in out:
        raise AssertionError(f"{label}: info does not name the card {name!r} and its memory")
    args = ["render", "--scene", "textured_hall", "--width", str(WIDTH), "--height",
            str(HEIGHT), "--spp", str(CLI_SPP), "--max-depth", str(MAX_DEPTH)]
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render.png")
        out, wall = run(*args, "--out", png)
        log(f"[{label}] render subprocess: {wall:.2f} s wall; it says: {out.strip()}")
        with open(png, "rb") as f:
            got = decode_png(f.read())[..., :3].astype(int)
        out, wall_p = run(*args, "--out", os.path.join(tmp, "p.png"), "--progressive",
                          str(CLI_PROGRESSIVE))
        writes = [ln for ln in out.splitlines() if "spp (" in ln]
        log(f"[{label}] --progressive {CLI_PROGRESSIVE}: {wall_p:.2f} s wall, "
            f"{len(writes)} writes: " + "; ".join(ln.strip() for ln in writes))
        if len(writes) != CLI_SPP // CLI_PROGRESSIVE:
            raise AssertionError(f"{label}: --progressive wrote {len(writes)} times")
        kernels.reset_launch_counts()  # the CLI's render, in this process
        t0 = time.perf_counter()
        rc = cli.main([*args, "--out", os.path.join(tmp, "in_process.png")])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        wall_i = time.perf_counter() - t0
        with open(os.path.join(tmp, "in_process.png"), "rb") as f:
            got_i = decode_png(f.read())[..., :3].astype(int)
    log(f"[{label}] cli.main(render) in this process: exit {rc}, {wall_i:.2f} s wall; "
        f"launches {counts}")
    if rc != 0:
        raise AssertionError(f"{label}: cli.main(render) returned {rc}")
    check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=CLI_SPP,
                       integrator=IntegratorConfig(max_depth=MAX_DEPTH))
    r = Renderer(*textured_hall(device=device), cfg, device=device)
    want = to_srgb_u8(r.render()).astype(int)
    for what, png in (("subprocess", got), ("in-process", got_i)):
        share = float((abs(png - want) <= 1).all(-1).mean())
        log(f"[{label}] the {what} CLI's PNG against to_srgb_u8 of a Renderer render: "
            f"{share:.4f} of pixels within 1 level")
        if share < PARITY_MIN_SHARE:
            raise AssertionError(f"{label}: the {what} CLI's PNG departs from the render")
    view_phase(label)
    raw = r.accum.image
    for what, fn in (("tonemap", partial(reinhard, cfg=ToneMapConfig(enabled=True))),
                     ("denoise", partial(bilateral, cfg=DenoiseConfig(enabled=True)))):
        ms, _, on_card = timed(lambda: fn(raw), KERNEL_REPS)
        on_cpu = fn(raw.cpu())
        ok = torch.allclose(on_card.cpu(), on_cpu, rtol=1e-5, atol=1e-6)
        err = (on_card.cpu() - on_cpu).abs().max().item()
        log(f"[{label}] {what} {WIDTH}x{HEIGHT} on the card: {ms:.3f} ms (median of {KERNEL_REPS}); "
            f"max |card - cpu| {err:.3e} (rtol 1e-5 / atol 1e-6: {ok}); card {card_line()}")
        if not ok:
            raise AssertionError(f"{label}: {what} on the card departs from the CPU's")
    return counts


VIEWER_FRAMES = 4  # [viewer]: frames before the edits
EDIT_FRAMES = 2  # [viewer]: frames after each edit
CHECKPOINT_FRAMES = 4  # [checkpoint]: frames before the save, and after the load


def http_get(port, path, timeout=120):
    """(status, body) of a GET on 127.0.0.1:``port``."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.status, resp.read()


def png_image(data: bytes):
    """(H, W, 3) float32 of PNG bytes, through ``utils/image.read_png``."""
    import tempfile

    from mcrt_tpu_torch.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "view.png")
        with open(path, "wb") as f:
            f.write(data)
        return read_png(path)


def viewer_phase(device):
    """Phase 11, ``[viewer]``: ``ProgressiveViewer`` on ``cornell_box`` at
    512x512, depth 8, Sobol (K4/K5), on 127.0.0.1 port 0, driven as a user
    drives it: ``VIEWER_FRAMES`` frames of ``serve`` with the launch
    counters around them (ms/spp printed), then ``/``, ``/image.png``
    (decoded by ``read_png``), ``/api/status`` and ``/api/stats`` (which
    must show the card's memory); then one edit of each kind through its
    HTTP endpoint (orbit, material, light, transform of a baked shape, the
    switch to ``glass_gallery``), each followed by ``EDIT_FRAMES`` frames:
    each must reset the spp and change the image; the material and light
    edits keep the intersector (``rebuild_accel=False``), the transform
    refits it.  A pick at the image centre, in this thread and over HTTP
    (the render loop in a second thread answers), must hit the shape the
    CPU's pick hits.  One more frame holds every K4/K5 launch against the
    plain versions on ``cornell_box``, and every K1-K3 launch after the
    switch.  Returns the launch counts of the first frames and of the
    frames after the switch."""
    import threading

    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.scene.builders import cornell_box
    from mcrt_tpu_torch.tools.card import card_line
    from mcrt_tpu_torch.viewer import ProgressiveViewer

    label = "viewer"
    cfg = main_cfg()
    scene, camera = cornell_box(device=device)
    t0 = time.perf_counter()
    v = ProgressiveViewer(Renderer(scene, camera, cfg, device=device), port=0,
                          scene_name="cornell_box")
    cpu = ProgressiveViewer(Renderer(*cornell_box(device="cpu"), cfg, device="cpu"), port=0)
    try:
        log(f"[{label}] serving on 127.0.0.1:{v.port}, set up in "
            f"{time.perf_counter() - t0:.2f} s")
        v.serve(max_steps=1)  # warm-up
        v.renderer.reset()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        busy0 = v.stats()["render_time_s"]
        t0 = time.perf_counter()
        v.serve(max_steps=VIEWER_FRAMES)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
        st = v.stats()
        log(f"[{label}] {VIEWER_FRAMES} frames of serve: {wall * 1e3 / VIEWER_FRAMES:.2f} ms/spp "
            f"(wall, publishing included), "
            f"{(st['render_time_s'] - busy0) * 1e3 / VIEWER_FRAMES:.2f} ms/spp (the viewer's "
            f"synced step times), {st['samples_per_sec']:.3f} spp/s (the last frame's); "
            f"launches {counts}; card {card_line()}")
        code, page = http_get(v.port, "/")
        _, png = http_get(v.port, "/image.png")
        img = png_image(png)
        status = json.loads(http_get(v.port, "/api/status")[1])
        stats = json.loads(http_get(v.port, "/api/stats")[1])
        log(f"[{label}] / {code} ({len(page)} bytes); /image.png {len(png)} bytes, "
            f"{img.shape}, mean {img.mean():.4f}; /api/status {status}; /api/stats {stats}")
        if (code != 200 or b"viewer" not in page or img.shape != (HEIGHT, WIDTH, 3)
                or not img.mean() > 0.0 or status["spp"] != VIEWER_FRAMES):
            raise AssertionError(f"{label}: the endpoints do not serve the render")
        if not 0 < stats["device_bytes_in_use"] < stats["device_bytes_limit"]:
            raise AssertionError(f"{label}: /api/stats does not show the card's memory")
        sel, ref = v.pick(0.5, 0.5), cpu.pick(0.5, 0.5)
        log(f"[{label}] pick (0.5, 0.5) on the card: {sel}; on the CPU: {ref}")
        if not sel["hit"] or (sel["shape"], sel["prim"]) != (ref["shape"], ref["prim"]):
            raise AssertionError(f"{label}: the card's pick departs from the CPU's")
        dense_frame_phase(lambda: v.serve(max_steps=1), label)

        edits = (("orbit", "/api/camera?yaw=0.3&pitch=0.1", "kept"),
                 ("material", "/api/material?id=1&r=0.2&g=0.7&b=0.3", "same"),
                 ("light", "/api/light?id=0&ir=30&ig=20&ib=10", "same"),
                 ("transform", "/api/transform?shape=5&x=0.2&y=0&z=0.1&ry=0.3", "refit"),
                 ("scene", "/api/scene?name=glass_gallery", "new"))
        switched = None
        for what, path, accel in edits:
            before = v.renderer.display_image().clone()
            isect = v.renderer.intersector
            code, _ = http_get(v.port, path)
            if what == "scene":
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            v.serve(max_steps=EDIT_FRAMES)
            wall = time.perf_counter() - t0
            if what == "scene":
                switched = kernels.launch_counts()
            after = v.renderer.display_image()
            changed = (after != before).any(-1).float().mean().item() if after.shape == \
                before.shape else 1.0
            same = v.renderer.intersector is isect
            refit = (not same and v.renderer.intersector.accel.slot_prim is isect.accel.slot_prim)
            spp = v.status()["spp"]
            log(f"[{label}] {what} edit ({code}): {wall:.2f} s for {EDIT_FRAMES} frames with the "
                f"edit; spp {spp}; pixels changed {changed:.4f}; intersector kept {same}, "
                f"refitted {refit}")
            if code != 200 or spp != EDIT_FRAMES or not changed > 0.0:
                raise AssertionError(f"{label}: the {what} edit did not reset the spp or change "
                                     "the image")
            if (accel == "same" and not same) or (accel == "refit" and not refit):
                raise AssertionError(f"{label}: the {what} edit did not keep ({accel}) the "
                                     "intersector")
        check_launches(f"{label}:glass_gallery", switched, ("K1", "K2", "K3"),
                       ("K4", "K5", "K6", "K7"))
        log(f"[{label}] glass_gallery after the switch: launches {switched}")
        cull_frame_phase(lambda: v.serve(max_steps=1), f"{label}:glass_gallery")
        walk_frame_phase(lambda: v.serve(max_steps=1), f"{label}:glass_gallery",
                         ids=("K2", "K3"))
        loop = threading.Thread(target=v.serve, daemon=True)
        loop.start()
        code, body = http_get(v.port, "/api/pick?u=0.5&v=0.5")
        over_http = json.loads(body)
        v.stop()
        loop.join(timeout=120)
        log(f"[{label}] pick over HTTP on glass_gallery (answered by the render loop): "
            f"{over_http}")
        if code != 200 or not over_http["hit"] or loop.is_alive():
            raise AssertionError(f"{label}: the pick over HTTP failed or the loop did not stop")
    finally:
        v.stop()
        cpu.stop()
    return counts, switched


def checkpoint_phase(device):
    """Phase 11, ``[checkpoint]``: ``textured_hall`` at 512x512, depth 8,
    Sobol (K4/K5) rendered ``CHECKPOINT_FRAMES`` frames on the card, saved
    (``save_accumulator``), loaded into a fresh ``Renderer`` (onto the
    card) and rendered ``CHECKPOINT_FRAMES`` more: the sums must equal
    those of ``2 * CHECKPOINT_FRAMES`` uninterrupted frames bit for bit.
    Then a ``save_pytree``/``restore_pytree`` round trip of
    ``full_params``, equal.  Returns the launch counts of the resumed
    frames."""
    import tempfile

    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.diff import estimators
    from mcrt_tpu_torch.scene.builders import textured_hall
    from mcrt_tpu_torch.utils import checkpoint

    label = "checkpoint"
    cfg = main_cfg()
    scene, camera = textured_hall(device=device)
    whole = Renderer(scene, camera, cfg, device=device)
    whole.step(2 * CHECKPOINT_FRAMES)
    first = Renderer(scene, camera, cfg, device=device)
    first.step(CHECKPOINT_FRAMES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "accum.npz")
        save_ms, _, _ = timed(lambda: checkpoint.save_accumulator(
            path, first.accum, extra={"frames": torch.tensor(CHECKPOINT_FRAMES)}), 1)
        size = os.path.getsize(path)
        resumed = Renderer(scene, camera, cfg, device=device)
        load_ms, _, (resumed.accum, extra) = timed(lambda: checkpoint.load_accumulator(path), 1)
        kernels.reset_launch_counts()
        resumed.step(CHECKPOINT_FRAMES)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        params = estimators.full_params().get(scene)
        tree = os.path.join(tmp, "params")
        checkpoint.save_pytree(tree, params)
        back = checkpoint.restore_pytree(tree, {k: torch.zeros_like(v) for k, v in params.items()})
    check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
    equal = (torch.equal(resumed.accum.weighted, whole.accum.weighted)
             and torch.equal(resumed.accum.weight, whole.accum.weight)
             and resumed.accum.frame == whole.accum.frame)
    err = (resumed.accum.weighted - whole.accum.weighted).abs().max().item()
    tree_ok = all(torch.equal(back[k], params[k]) and back[k].device == params[k].device
                  for k in params)
    log(f"[{label}] textured_hall {WIDTH}x{HEIGHT}, {MAX_DEPTH} bounces: save {save_ms:.1f} ms "
        f"({size} bytes), load {load_ms:.1f} ms onto {resumed.accum.weighted.device}, extra "
        f"{ {k: v.tolist() for k, v in extra.items()} }; {CHECKPOINT_FRAMES} + "
        f"{CHECKPOINT_FRAMES} frames equal to {2 * CHECKPOINT_FRAMES} uninterrupted ones bit "
        f"for bit: {equal} (max |diff| {err:.3e}); full_params round trip equal: {tree_ok}; "
        f"launches {counts}")
    if not equal or not tree_ok:
        raise AssertionError(f"{label}: the resumed render or the tree departs")
    return counts


def profiler_phase(device):
    """Phase 11, ``[profiler]``: ``utils/profiling.py`` spans (``frame``
    synced on the accumulator, ``step`` inside it) around 2 frames of
    ``cornell_box`` at 512x512, depth 8, under ``device_trace`` into a
    temporary directory: the span report printed, the trace file must
    exist and hold the spans; its kernel events are counted.  Returns the
    launch counts of the traced frames."""
    import glob
    import tempfile

    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.scene.builders import cornell_box
    from mcrt_tpu_torch.utils import profiling

    label = "profiler"
    r = Renderer(*cornell_box(device=device), main_cfg(), device=device)
    r.step(1)
    prof = profiling.Profiler()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.device_trace(tmp):
            for _ in range(2):
                with prof.span("frame", sync=r.accum.weight):
                    with prof.span("step"):
                        r.step(1)
        traced_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        files = glob.glob(os.path.join(tmp, "trace-*.json"))
        if len(files) != 1:
            raise AssertionError(f"{label}: device_trace wrote {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    device_events = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    device_ms = sum(e.get("dur", 0) for e in device_events) / 1e3
    log(f"[{label}] 2 traced frames in {traced_s:.2f} s; trace {os.path.basename(files[0])} "
        f"{size} bytes, {len(events)} events, {len(device_events)} device events "
        f"({device_ms:.1f} ms of device time); spans in the trace: "
        f"{sorted(n for n in names if n in ('frame', 'step'))}; launches {counts}")
    log(f"[{label}] span report:\n{prof.report()}")
    stats = prof.stats()
    if stats["frame"].count != 2 or stats["frame/step"].count != 2 or \
            not {"frame", "step"} <= names:
        raise AssertionError(f"{label}: the spans are not counted or not in the trace")
    check_launches(label, counts, ("K4", "K5"), ("K1", "K2", "K3", "K6", "K7"))
    return counts


LBVH_FRAMES = 1  # [lbvh]: timed frames after the warm one (each several seconds)
ORACLE_RAYS = 4096  # [brute]: rays of a 512x512 wavefront the oracle is held on
RING_BRUTE_SIZE = 64  # [ring4_brute]: the wavefront's width and height
BLOCKED_IDS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")
LBVH_FIELDS = ("node_min", "node_max", "left", "right", "prim", "prim_valid", "packed", "child",
               "leaf_rows", "unified", "unified_child")


def compare_hits(label, what, rays, got, ref, allowed=0, oracle=None, t_tol=(1e-5, 1e-6),
                 same_id="prim", min_same=0.97):
    """``got`` = (hit, blocked) of the LBVH or the oracle against ``ref``'s,
    under ``tests/test_lbvh.py``'s rules: hit flags equal, t within
    ``t_tol`` (rtol, atol) where both hit, ``same_id`` ids equal on more
    than ``min_same`` of those hits (ties at shared edges), blocked flags
    equal.  ``allowed``: flags that may differ where ``ref`` comes from a
    list walk (K2/K3, K6/K7), the walks' own tolerance; ``oracle(rays)``,
    where given, must then agree with ``got`` on every ray that differs.
    Returns the rays that differ."""
    import torch

    (hit, blocked), (ref_hit, ref_blocked) = got, ref
    flag = hit.valid != ref_hit.valid
    occ = blocked != ref_blocked
    both = hit.valid & ref_hit.valid
    t_off = both & ~torch.isclose(hit.t, ref_hit.t, rtol=t_tol[0], atol=t_tol[1])
    same = (getattr(hit, same_id) == getattr(ref_hit, same_id))[both].float().mean().item()
    n_flag, n_occ = int(flag.sum()), int(occ.sum())
    log(f"[{label}] {what}: {int(hit.valid.sum())} hits ({int(ref_hit.valid.sum())}), flags "
        f"differing {n_flag}, t off {int(t_off.sum())}, same {same_id} {same:.5f}; "
        f"{int(blocked.sum())} blocked ({int(ref_blocked.sum())}), differing {n_occ}; "
        f"allowed {allowed}")
    if n_flag or n_occ:
        idx = (flag | occ).nonzero()[:, 0]
        if oracle is not None:
            o_hit, o_blocked = oracle(rays_take(rays, idx))
            wrong = (hit.valid[idx] != o_hit.valid) | (blocked[idx] != o_blocked)
            log(f"[{label}] {what}: the oracle on the {idx.numel()} differing rays agrees "
                f"with {idx.numel() - int(wrong.sum())} of them")
            if wrong.any():
                raise AssertionError(f"{label}: {what}: departs from the oracle")
    if n_flag > allowed or n_occ > allowed or t_off.any() or not same > min_same:
        raise AssertionError(f"{label}: {what}: the hits depart")


def rays_take(rays, idx):
    from mcrt_tpu_torch.core.types import Rays

    return Rays(o=rays.o[idx], d=rays.d[idx], tmin=rays.tmin[idx], tmax=rays.tmax[idx],
                active=rays.active[idx])


def oracle_sample(rays):
    """``ORACLE_RAYS`` rays spread evenly over a wavefront."""
    import torch

    return rays_take(rays, torch.arange(0, rays.n, rays.n // ORACLE_RAYS,
                                        device=rays.o.device)[:ORACLE_RAYS])


def query_stats(fn):
    """(ms, result, the LBVH walk's STATS for one synced call of ``fn``)."""
    from mcrt_tpu_torch.accel import traverse

    traverse.reset_stats()
    ms, _, out = timed(fn, 1)
    return ms, out, dict(traverse.STATS)


def lbvh_phase(scene, camera, device):
    """Phase 12, ``[lbvh]``: ``AccelType.LBVH`` on ``sphere_field``
    (245,764 triangles, leaf size 2).  The launch counters are set to 0
    before the LBVH's build and read after its frames; K1-K7 must read 0.
    The build's card time and fixpoint steps; on phase 2's 512x512 primary
    and bounce wavefronts the closest-hit and occlusion queries' times, loop
    iterations and host syncs, and ``traversal_iterations``' lockstep count
    and visits; one warm and ``LBVH_FRAMES`` timed progressive frames
    through ``Renderer`` at 512x512, depth 8 (ms/spp; the walk's
    iterations and syncs a frame), and one more frame under the sync
    counter.  The card's build must equal a CPU build field for field (the
    CPU tests hold the CPU build to the JAX package's).  Then the
    wavefronts' hits are held against the blocked
    queries' (K1-K3, run before the counters were reset) by
    ``compare_hits``: the list walks may differ from their plain versions
    on ``walk_allowed`` rays, so the LBVH may too, where the brute-force
    oracle agrees with the LBVH.  Returns (launch counts, the build)."""
    import dataclasses

    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import kernels, traverse
    from mcrt_tpu_torch.accel.blocked import build_blocked, intersect_blocked, occluded_blocked
    from mcrt_tpu_torch.accel.brute import intersect_brute, occluded_brute
    from mcrt_tpu_torch.accel.lbvh import build_lbvh
    from mcrt_tpu_torch.config import AccelType
    from mcrt_tpu_torch.tools.card import card_line
    from mcrt_tpu_torch.tools.profile_frame import sync_sites
    from mcrt_tpu_torch.tools.wavefronts import wavefronts

    label = "lbvh"
    geom = scene.geometry
    accel = build_blocked(geom)
    waves = wavefronts(camera, lambda r: intersect_blocked(geom, accel, r), device)
    refs = {wf: (intersect_blocked(geom, accel, r), occluded_blocked(geom, accel, r))
            for wf, r in waves.items()}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    build_ms, _, bvh = timed(lambda: build_lbvh(geom), 1)
    log(f"[{label}] build on the card: {build_ms:.1f} ms, {bvh.num_leaves} leaves of "
        f"{bvh.leaf_size}, {bvh.num_nodes} nodes, fixpoint steps {bvh.fit_iterations}, host "
        f"syncs {bvh.fit_syncs}; card {card_line()}")
    got = {}
    for wf, rays in waves.items():
        c_ms, hit, c_st = query_stats(lambda: traverse.intersect_bvh(geom, bvh, rays))
        o_ms, blocked, o_st = query_stats(lambda: traverse.occluded_bvh(geom, bvh, rays))
        iters, visits = traverse.traversal_iterations(bvh, rays)
        live = visits[rays.active].float()
        got[wf] = (hit, blocked)
        log(f"[{label}:{wf}] closest hit {c_ms:.1f} ms, {c_st['iterations']} iterations, "
            f"{c_st['syncs']} syncs; occlusion {o_ms:.1f} ms, {o_st['iterations']} "
            f"iterations, {o_st['syncs']} syncs; traversal_iterations: {iters} lockstep "
            f"iterations, visits a live ray mean {live.mean().item():.2f}, max "
            f"{int(visits.max())}, total {int(visits.sum())}")
    cfg = dataclasses.replace(main_cfg(), accel=AccelType.LBVH)
    t0 = time.perf_counter()
    renderer = Renderer(scene, camera, cfg, device=device)
    set_up = time.perf_counter() - t0
    warm, _, _ = timed(lambda: renderer.step(1), 1)
    renderer.step(1)  # the shading graphs' capture frame
    traverse.reset_stats()
    ms, frame_ms, _ = timed(lambda: renderer.step(1), LBVH_FRAMES)
    st = {k: v // LBVH_FRAMES for k, v in traverse.STATS.items()}
    sites = sync_sites(lambda: renderer.step(1))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    img = renderer.display_image()
    mean = img.mean().item()
    log(f"[{label}] Renderer {cfg.width}x{cfg.height}, {cfg.integrator.max_depth} bounces, "
        f"sobol, accel lbvh: set-up "
        f"(build) {set_up:.2f} s, warm frame {warm:.0f} ms, timed frames (ms) "
        + ", ".join(f"{t:.0f}" for t in frame_ms) + f": {ms:.1f} ms/spp; a frame: "
        f"{st['queries']} queries, {st['iterations']} walk iterations, {st['syncs']} walk "
        f"syncs; synchronizing calls in one frame {sum(sites.values())} ("
        + ", ".join(f"{s} x{n}" for s, n in sites.most_common(3)) + f"); image mean "
        f"{mean:.5f}; launches {counts}; card {card_line()}")
    check_launches(label, counts, (), BLOCKED_IDS)
    if not bool(torch.isfinite(img).all()) or not mean > 0.0:
        raise AssertionError(f"{label}: image not finite/positive (mean {mean})")
    cpu = build_lbvh(geom.to("cpu"))
    differ = [f for f in LBVH_FIELDS if not torch.equal(getattr(bvh, f).cpu(), getattr(cpu, f))]
    log(f"[{label}] the card's build against the CPU's, field for field: "
        f"{'equal' if not differ else 'differs in ' + ', '.join(differ)}")
    if differ or cpu.fit_iterations != bvh.fit_iterations:
        raise AssertionError(f"{label}: the card's build departs from the CPU's")
    for wf, rays in waves.items():
        compare_hits(f"{label}:{wf}", "against the blocked queries (K1-K3)", rays, got[wf],
                     refs[wf], walk_allowed(rays.active),
                     lambda r: (intersect_brute(geom, r), occluded_brute(geom, r)))
    return counts, bvh


def baked_geometry(scene):
    """The world-space faces of an instanced scene in one soup, as the JAX
    tests bake them: every face as it is (free geometry and the sources)
    and, for each instance,
    its source's faces through ``shapes.to_world`` (its shape id), the
    shape ids the two-level query reports."""
    import torch

    g = scene.geometry
    valid = g.face_valid.nonzero()[:, 0]
    p = torch.stack(g.face_vertices(valid), dim=1)  # (F, 3, 3)
    tris, shapes = [p], [g.face_shape[valid]]
    inst = scene.instances
    for k in range(inst.num):
        faces = torch.arange(inst.face_lo[k], inst.face_hi[k], device=p.device)
        faces = faces[g.face_valid[faces]]
        tw = scene.shapes.to_world[inst.shape[k]]
        src = torch.stack(g.face_vertices(faces), dim=1)
        tris.append(src @ tw[:3, :3].T + tw[:3, 3])
        shapes.append(torch.full((faces.numel(),), int(inst.shape[k]), dtype=torch.int32,
                                 device=p.device))
    pos = torch.cat(tris).reshape(-1, 3)
    n = pos.shape[0] // 3
    return g.replace(positions=pos, indices=torch.arange(3 * n, dtype=torch.int32,
                                                         device=pos.device).reshape(n, 3),
                     face_shape=torch.cat(shapes),
                     face_valid=torch.ones((n,), dtype=torch.bool, device=pos.device),
                     face_attrs=torch.zeros((n, 1), device=pos.device), instanced=False)


def brute_phase(scene, camera, bvh, device):
    """Phase 12, ``[brute]``: the oracle (``AccelType.BRUTE``) on the card.
    References first, with the launch counters running: K4/K5's queries on
    ``textured_hall``'s full 512x512 wavefronts, K2/K3's and the LBVH's on
    ``ORACLE_RAYS`` rays of ``sphere_field``'s, K6/K7's on as many of
    ``sphere_field_instanced``'s, and one ``AUTO`` frame of ``cornell_box``
    (512x512, depth 8, K4/K5).  Then, with the counters set to 0 (K1-K7
    must read 0): the oracle on the same rays (``sphere_field_instanced``'s
    through its baked world-space faces) and one ``BRUTE`` frame of
    ``cornell_box`` from the same streams under the sync check.  Held by
    ``compare_hits``: against K4/K5 and the LBVH exactly, against the list
    walks within ``walk_allowed`` (K6/K7 at ``tests/test_two_level.py``'s
    t tolerance of the baked rounding, 2e-4, shape ids on 99%); the frames
    at the parity share.  Query times printed beside the references'."""
    import dataclasses

    import torch

    from mcrt_tpu_torch import Renderer
    from mcrt_tpu_torch.accel import build_intersector, kernels, traverse
    from mcrt_tpu_torch.accel.brute import intersect_brute, occluded_brute
    from mcrt_tpu_torch.config import AccelType
    from mcrt_tpu_torch.scene.builders import cornell_box, sphere_field_instanced, textured_hall
    from mcrt_tpu_torch.tools.card import card_line
    from mcrt_tpu_torch.tools.wavefronts import wavefronts

    label = "brute"
    cases = {}  # name: (geometry the oracle takes, rays, reference, its ms, options)
    hall, hall_cam = textured_hall(device=device)
    isect = build_intersector(hall, main_cfg())
    for wf, rays in wavefronts(hall_cam, lambda r: isect.intersect(hall, r), device).items():
        ms, _, ref = timed(lambda: (isect.intersect(hall, rays), isect.occluded(hall, rays)),
                           KERNEL_REPS)
        cases[f"textured_hall:{wf}"] = (hall.geometry, rays, ref, ms, {}, "K4/K5")
    isect = build_intersector(scene, main_cfg())
    for wf, rays in wavefronts(camera, lambda r: isect.intersect(scene, r), device).items():
        rays = oracle_sample(rays)
        ms, _, ref = timed(lambda: (isect.intersect(scene, rays), isect.occluded(scene, rays)),
                           KERNEL_REPS)
        opts = dict(allowed=walk_allowed(rays.active))
        cases[f"sphere_field:{wf}"] = (scene.geometry, rays, ref, ms, opts, "K1-K3")
        ms, _, ref = timed(lambda: (traverse.intersect_bvh(scene.geometry, bvh, rays),
                                    traverse.occluded_bvh(scene.geometry, bvh, rays)), 1)
        cases[f"sphere_field:{wf}:lbvh"] = (scene.geometry, rays, ref, ms, {}, "the LBVH")
    inst, inst_cam = sphere_field_instanced(device=device)
    isect = build_intersector(inst, main_cfg())
    baked = baked_geometry(inst)
    for wf, rays in wavefronts(inst_cam, lambda r: isect.intersect(inst, r), device).items():
        rays = oracle_sample(rays)
        ms, _, ref = timed(lambda: (isect.intersect(inst, rays), isect.occluded(inst, rays)),
                           KERNEL_REPS)
        opts = dict(allowed=walk_allowed(rays.active), t_tol=(2e-4, 2e-4), same_id="shape",
                    min_same=0.99)
        cases[f"sphere_field_instanced:{wf}"] = (baked, rays, ref, ms, opts, "K1+K6/K7")
    box, box_cam = cornell_box(device=device)
    cfg = main_cfg(spp=1)
    auto = Renderer(box, box_cam, cfg, device=device)
    auto_ms, _, _ = timed(lambda: auto.step(1), 1)

    g, rays = next(iter(cases.values()))[:2]
    intersect_brute(g, rays), occluded_brute(g, rays)  # warm-up: torch's first launches
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = {}
    for name, (g, rays, _, _, _, _) in cases.items():
        ms, _, out = timed(lambda: (intersect_brute(g, rays), occluded_brute(g, rays)), 1)
        got[name] = (out, ms)
    r = Renderer(box, box_cam, dataclasses.replace(cfg, accel=AccelType.BRUTE), device=device)
    times = frames_timed(label, [lambda: r.step(1)])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[{label}] cornell_box {cfg.width}x{cfg.height}, {cfg.integrator.max_depth} "
        f"bounces, sobol: brute frame "
        f"{times[0]:.1f} ms (no sync), AUTO (K4/K5) frame {auto_ms:.1f} ms; launches during "
        f"the oracle's queries and frame {counts}; card {card_line()}")
    check_launches(label, counts, (), BLOCKED_IDS)
    agreement(label, "the BRUTE frame against the AUTO (K4/K5) frame", r.display_image(),
              auto.display_image())
    for name, (g, rays, ref, ref_ms, opts, what) in cases.items():
        out, ms = got[name]
        log(f"[{label}:{name}] {rays.n} rays, {g.num_faces} faces: the oracle's closest hit "
            f"and occlusion {ms:.1f} ms, {what}'s {ref_ms:.2f} ms")
        compare_hits(f"{label}:{name}", f"the oracle against {what}", rays, out, ref, **opts)
    return counts


def ring4_brute_phase(scene, camera, device):
    """Phase 12, ``[ring4_brute]``: ``[ring4]``'s four shards of
    ``sphere_field`` with the ring's brute-force variant
    (``use_blocked=False``, ``ShardedFaces``): its steps over the four
    shards in ring order, in one process, on a 64x64 primary and bounce
    wavefront, the rays unsorted as that variant takes them.  The launch
    counters are set to 0 before the brute steps and read after them (K1-K7
    must read 0); then the blocked ring's steps on the same rays are the
    reference, under ``[ring4]``'s rules (flags within the walks'
    tolerance, t at rtol 1e-5 where both hit).  Both times printed."""
    import torch

    from mcrt_tpu_torch.accel import build_intersector, kernels
    from mcrt_tpu_torch.accel.blocked import _coherence_order
    from mcrt_tpu_torch.core.types import Hit
    from mcrt_tpu_torch.parallel.ring import (ShardedFaces, _build_shard_accels, _take,
                                              _unsort, closest_step, occluded_step,
                                              shard_faces)
    from mcrt_tpu_torch.tools.card import card_line
    from mcrt_tpu_torch.tools.wavefronts import wavefronts

    label = "ring4_brute"
    geom = shard_faces(scene.geometry, RING_SHARDS)
    fpad = geom.indices.shape[0] // RING_SHARDS
    blocked_acc = _build_shard_accels(geom, RING_SHARDS, fpad, device=device)
    brute_acc = ShardedFaces()
    whole = build_intersector(scene, main_cfg())
    wfs = wavefronts(camera, lambda r: whole.intersect(scene, r), device, RING_BRUTE_SIZE,
                     RING_BRUTE_SIZE)

    def ring(acc, rays, order):
        rays_s, best = _take(rays, order), Hit.none(rays.n, device)
        occ_s = rays_s
        blocked = torch.zeros((rays.n,), dtype=torch.bool, device=device)
        for s in range(RING_SHARDS):
            best = closest_step(geom, acc, s, fpad, rays_s, best)
            occ_s, blocked = occluded_step(geom, acc, s, fpad, occ_s, blocked)
        out = torch.empty_like(blocked)
        out[order] = blocked
        return _unsort(best, order), out

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = {}
    for wf, rays in wfs.items():
        ms, _, out = timed(lambda: ring(brute_acc, rays, torch.arange(rays.n, device=device)),
                           1)
        got[wf] = (out, ms)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"[{label}] {RING_SHARDS} shards of {fpad} faces, {RING_BRUTE_SIZE}x{RING_BRUTE_SIZE} "
        f"wavefronts; launches during the brute steps {counts}")
    check_launches(label, counts, (), BLOCKED_IDS)
    for wf, rays in wfs.items():
        out, ms = got[wf]
        order = _coherence_order(rays, blocked_acc.bounds)
        ref_ms, _, ref = timed(lambda: ring(blocked_acc, rays, order), KERNEL_REPS)
        log(f"[{label}:{wf}] the brute ring's four steps (closest hit and occlusion) {ms:.1f} "
            f"ms; the blocked ring's {ref_ms:.2f} ms; card {card_line()}")
        compare_hits(f"{label}:{wf}", "against the blocked ring", rays, out, ref,
                     walk_allowed(rays.active))
    return counts


def accel_phases(scene, camera, device):
    """Phase 12: ``[lbvh]``, ``[brute]`` and ``[ring4_brute]``, each with
    the launch counters around the LBVH's or the oracle's work; returns
    each phase's launch counts."""
    counts = {}
    counts["lbvh"], bvh = lbvh_phase(scene, camera, device)
    counts["brute"] = brute_phase(scene, camera, bvh, device)
    counts["ring4_brute"] = ring4_brute_phase(scene, camera, device)
    return counts


STANDIN_SUBDIV = 4  # the stand-in mesh: an icosphere of 20 * 4**4 = 5,120 triangles
STANDIN_TRIANGLES = {"bunny_field": 49 * 5120 + 2, "heavy_gallery": 36 * 5120 + 4}
LOOP_GRID = 10  # [loop_oracle]: instances a side, tests/test_two_level.py's 100-instance grid
LOOP_RAYS = 262144  # [loop_oracle]: random rays made from a numpy seed
LOOP_T_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_two_level.py's bound on t
HEAVY_REL = 0.02  # tests/test_heavy_golden.py's bound on the mean-relative difference
PARITY_GRID = 2  # [heavy_gallery]'s card-against-CPU parity: bunnies a side


def write_standin_obj(path, subdiv=STANDIN_SUBDIV, attributes=True):
    """Writes a closed, non-convex mesh to ``path`` as an OBJ file, in the
    place of the Stanford bunny (``bunny.obj``, which is not in the
    repository): an icosphere of ``20 * 4**subdiv`` triangles, each vertex
    moved along its direction by a sum of low-frequency sinusoids, so the
    surface has hollows and bumps.  With ``attributes``, each vertex also
    gets its spherical uv (``vt``) and its area-weighted normal (``vn``);
    without, faces name positions alone, as the bunny's file does, and a
    loader computes the normals.  The same arguments write the same bytes."""
    import numpy as np

    from mcrt_tpu_torch.scene.builders import icosphere

    unit, faces, _ = icosphere((0.0, 0.0, 0.0), 1.0, subdiv=subdiv)
    d = unit.astype(np.float64)
    x, y, z = d.T
    r = (1.0 + 0.18 * np.sin(3.0 * x + 1.0) * np.cos(2.0 * y) + 0.12 * np.sin(4.0 * z - 0.5)
         + 0.08 * np.cos(5.0 * y + 2.0 * x))
    pos = d * r[:, None]
    lines = [f"# stand-in mesh: icosphere subdiv {subdiv}, radially displaced\n"]
    lines += [f"v {a:.7f} {b:.7f} {c:.7f}\n" for a, b, c in pos]
    if attributes:
        u = 0.5 + np.arctan2(z, x) / (2.0 * np.pi)
        v = 0.5 + np.arcsin(np.clip(y, -1.0, 1.0)) / np.pi
        p = pos[faces]
        fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        n = np.zeros_like(pos)
        for k in range(3):
            np.add.at(n, faces[:, k], fn)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        lines += [f"vt {a:.7f} {b:.7f}\n" for a, b in zip(u, v)]
        lines += [f"vn {a:.7f} {b:.7f} {c:.7f}\n" for a, b, c in n]
        lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in f) + "\n" for f in faces]
    else:
        lines += [f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces]
    with open(path, "w") as fh:
        fh.writelines(lines)
    return path


def mean_relative(a, ref) -> float:
    """``tests/test_heavy_golden.py``'s measure: mean |a - ref| over the
    mean of ``ref``."""
    return ((a - ref).abs().mean() / max(ref.mean().item(), 1e-6)).item()


def check_queries(label, what, hit, blocked, ref_hit, ref_blocked):
    """``tests/test_two_level.py``'s criteria: valid flags equal, t within
    ``LOOP_T_TOL`` on the valid rays, occluded flags equal."""
    import torch

    valid = ref_hit.valid
    flags = int((hit.valid != valid).sum())
    t_off = int((valid & ~torch.isclose(hit.t, ref_hit.t, **LOOP_T_TOL)).sum())
    occ = int((blocked != ref_blocked).sum())
    err = (hit.t[valid] - ref_hit.t[valid]).abs().max().item() if valid.any() else 0.0
    log(f"[{label}] {what}: {int(valid.sum())} hits, {int(ref_blocked.sum())} blocked of "
        f"{valid.numel()} rays; differing valid flags {flags}, t beyond rtol "
        f"{LOOP_T_TOL['rtol']} / atol {LOOP_T_TOL['atol']} {t_off} (max |dt| {err:.3e}), "
        f"occluded flags {occ}")
    if flags or t_off or occ:
        raise AssertionError(f"{label}: {what} differ")


def check_loop_launches(label, counts, instances):
    """The loop oracle's launches: one closest-hit and one occlusion walk
    (K2, K3) an instance, none of K4-K7."""
    check_launches(label, counts, ("K1", "K2", "K3"), ("K4", "K5", "K6", "K7"))
    if counts["K2"] != instances or counts["K3"] != instances:
        raise AssertionError(f"{label}: the loop did not query once an instance: {counts}")


def loop_oracle_phase(bare, bfi_scene, device):
    """``[loop_oracle]``: the stand-in mesh (scaled by 0.4) in
    ``tests/test_two_level.py``'s 100-instance grid; ``LOOP_RAYS`` random
    rays (numpy seed 7, spread over the grid as that test spreads them)
    through K6/K7 (``intersect_two_level`` / ``occluded_two_level``) and
    through the per-instance loop of flat queries (K1-K3 once an instance),
    under the test's criteria; then the same rays through
    ``bunny_field_instanced``'s accel unsorted (``sort=False``) against
    sorted.  Returns the launch counts of the phase."""
    import numpy as np
    import torch

    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.accel import two_level as tl
    from mcrt_tpu_torch.core.types import Rays
    from mcrt_tpu_torch.scene import builders
    from mcrt_tpu_torch.scene.dynamic import translation
    from mcrt_tpu_torch.scene.objloader import load_obj
    from mcrt_tpu_torch.tools.card import card_line

    label = "loop_oracle"
    mesh = load_obj(bare)
    sb = builders.SceneBuffers()
    sb.add_mesh(mesh.positions * np.float32(0.4), mesh.indices, 0, normals=mesh.normals)
    positions, normals, uvs, indices, face_shape, shape_mat, _ = sb.concat()
    src = builders.build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                               [builders.UberMaterial(diffuse=(0.5,) * 3)], device=device)
    tw = np.stack([translation((ix * 1.2, 0.0, iz * 1.2))
                   for ix in range(LOOP_GRID) for iz in range(LOOP_GRID)])
    t0 = time.perf_counter()
    accel = tl.build_two_level(src.geometry, tw, np.arange(len(tw), dtype=np.int32))
    log(f"[{label}] {len(indices)} source triangles, {accel.num_instances} instances, "
        f"{accel.blas.num_blocks} BLAS blocks, {accel.num_pairs} pairs, built in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(7)
    o = rng.uniform(-2.5, 2.5, (LOOP_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(LOOP_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (o * np.float32([3.0, 1.0, 3.0]) + np.float32([5.0, 0.0, 5.0])).astype(np.float32)
    rays = Rays.make(torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))
    geom = src.geometry

    def both(intersect, occluded, what, **kw):
        kernels.reset_launch_counts()
        ms, _, out = timed(lambda: (intersect(geom, accel, rays, **kw),
                                    occluded(geom, accel, rays, **kw)), 1)
        counts = kernels.launch_counts()
        log(f"[{label}] {what}: closest hit and occlusion {ms:.2f} ms, launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        return out, counts

    pair, counts = both(tl.intersect_two_level, tl.occluded_two_level, "K6/K7")
    check_launches(label, counts, ("K1", "K6", "K7"), ("K2", "K3", "K4", "K5"))
    loop, loop_counts = both(tl.intersect_two_level_loop, tl.occluded_two_level_loop,
                             "the loop of flat queries")
    check_loop_launches(label, loop_counts, accel.num_instances)
    check_queries(label, "K6/K7 against the loop", *pair, *loop)
    total = {k: counts[k] + loop_counts[k] for k in counts}

    geom = bfi_scene.geometry
    accel = tl.build_two_level_scene(geom, bfi_scene.shapes.to_world, bfi_scene.instances)
    unsorted, counts = both(tl.intersect_two_level, tl.occluded_two_level,
                            "bunny_field_instanced unsorted", sort=False)
    check_launches(label, counts, ("K1", "K6", "K7"), ("K2", "K3", "K4", "K5"))
    ordered, sorted_counts = both(tl.intersect_two_level, tl.occluded_two_level,
                                  "bunny_field_instanced sorted")
    check_queries(label, "bunny_field_instanced's queries unsorted against sorted",
                  *unsorted, *ordered)
    log(f"[{label}] card {card_line()}")
    return {k: total[k] + counts[k] + sorted_counts[k] for k in total}


def bunny_phases(device):
    """Phase 13: the three ``bunny.obj`` scenes on a stand-in mesh written
    by ``write_standin_obj`` into a temporary directory (with ``vn``/``vt``
    for ``heavy_gallery``, positions alone for the others), at their
    default grids, and the loop oracle.  Returns (each main-path phase's
    ``main_path_phase`` result, each phase's launch counts)."""
    import tempfile

    import numpy as np

    from mcrt_tpu_torch.scene import builders
    from mcrt_tpu_torch.scene.objloader import load_obj

    k1_3, k4_5, k6_7 = ("K1", "K2", "K3"), ("K4", "K5"), ("K6", "K7")
    walk = partial(walk_frame_phase, ids=k1_3[1:])
    with tempfile.TemporaryDirectory() as tmp:
        full = write_standin_obj(os.path.join(tmp, "standin_vn_vt.obj"))
        bare = write_standin_obj(os.path.join(tmp, "standin.obj"), attributes=False)
        a, b = load_obj(full), load_obj(bare)
        n_err = float(np.abs(a.normals - b.normals).max())
        log(f"[bunny] stand-in mesh: {len(b.indices)} triangles, {len(b.positions)} vertices; "
            f"the loader's normals of the file without vn against the file's vn: max |dn| "
            f"{n_err:.2e}")
        if not np.array_equal(a.positions, b.positions) or n_err > 1e-4:
            raise AssertionError("bunny: the two stand-in files load to different meshes")
        scenes = {"bunny_field": builders.bunny_field(bunny_path=bare, device=device),
                  "heavy_gallery": builders.heavy_gallery(bunny_path=full, device=device)}
        for name, (scene, _) in scenes.items():
            faces = int(scene.geometry.face_valid.sum())
            log(f"[{name}] {faces} triangles")
            if faces != STANDIN_TRIANGLES[name]:
                raise AssertionError(f"{name}: {faces} triangles")
        bfi = builders.bunny_field_instanced(bunny_path=bare, device=device)
        log(f"[bunny_field_instanced] one {len(b.indices)}-triangle BLAS in "
            f"{bfi[0].instances.num} instances")
        if bfi[0].instances.num != 48:
            raise AssertionError("bunny_field_instanced: not 48 instances")
        paths = {
            "bunny_field": main_path_phase("bunny_field", *scenes["bunny_field"], device, k1_3,
                                           k4_5 + k6_7, frame_phases=(cull_frame_phase, walk)),
            "heavy_gallery": main_path_phase("heavy_gallery", *scenes["heavy_gallery"], device,
                                             k1_3, k4_5 + k6_7,
                                             frame_phases=(cull_frame_phase, walk)),
            "heavy_gallery_sbvh": main_path_phase("heavy_gallery_sbvh",
                                                  *scenes["heavy_gallery"], device, k1_3,
                                                  k4_5 + k6_7, cfg=main_cfg("SBVH")),
        }
        sah, sbvh = paths["heavy_gallery"][4], paths["heavy_gallery_sbvh"][4]
        rel = mean_relative(sbvh, sah)
        log(f"[heavy_gallery_sbvh] mean-relative difference from the SAH image {rel:.5f} "
            f"(bound {HEAVY_REL})")
        agreement("heavy_gallery_sbvh", "against the SAH render of the same frames", sbvh, sah)
        if rel >= HEAVY_REL:
            raise AssertionError(f"heavy_gallery: SBVH and SAH images differ by {rel:.5f}")
        paths["heavy_gallery_bdpt"] = main_path_phase(
            "heavy_gallery_bdpt", *scenes["heavy_gallery"], device, k1_3, k4_5 + k6_7,
            cfg=main_cfg(integrator="BDPT", size=128, depth=3))
        paths["bunny_field_instanced"] = main_path_phase(
            "bunny_field_instanced", *bfi, device, ("K1",) + k6_7, k1_3[1:] + k4_5,
            frame_phases=(cull_frame_phase, partial(walk_frame_phase, ids=k6_7)))
        counts = {label: v[0] for label, v in paths.items()}
        counts["loop_oracle"] = loop_oracle_phase(bare, bfi[0], device)
        parity_phase("heavy_gallery", builder_kw=dict(grid=PARITY_GRID, bunny_path=full))
    return paths, counts


def api_phase(scene, device):
    """Phase 14, ``[api]``: the names of the JAX package's public surface
    that touch the card, each with no device given.  Returns the launch
    counts around it, which must be 0."""
    import torch

    from mcrt_tpu_torch.accel import kernels
    from mcrt_tpu_torch.core.types import F32_MAX, Hit
    from mcrt_tpu_torch.film.accumulate import Accumulator
    from mcrt_tpu_torch.runtime import buffers, device_memory_stats, enumerate_devices
    from mcrt_tpu_torch.runtime.native import get_lib
    from mcrt_tpu_torch.runtime.platform import nbytes
    from mcrt_tpu_torch.sampling.sobol import sobol_matrices
    from mcrt_tpu_torch.tools.card import card_line

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hit = Hit.none(4096)
    accum = Accumulator.zeros(512, 512)
    mats = sobol_matrices()
    stats = device_memory_stats(index=0)
    devices = enumerate_devices()
    lib = get_lib()
    size = buffers.register("scene", scene)
    buffers.release("scene")
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    limit = torch.cuda.mem_get_info(0)[1]
    places = {f"Hit.{f}": getattr(hit, f).device.type
              for f in ("t", "prim", "shape", "u", "v", "valid")}
    places.update({f"Accumulator.{f}": getattr(accum, f).device.type
                   for f in ("weighted", "weight")})
    places["sobol_matrices"] = mats.device.type
    log(f"[api] card: {card_line()}; Hit.none(4096), Accumulator.zeros(512, 512) and "
        f"sobol_matrices() on "
        f"{sorted(set(places.values()))}; device_memory_stats(index=0) {stats} "
        f"(mem_get_info limit {limit}); enumerate_devices() "
        f"{[(d.index, d.platform, d.kind, d.memory_bytes) for d in devices]}; get_lib() {lib}; "
        f"buffers.register('scene', sphere_field) {size} bytes (nbytes {nbytes(scene)}); "
        f"launches {counts}; {ms:.2f} ms")
    if set(places.values()) != {"cuda"}:
        raise AssertionError(f"[api] a constructor without a device left the card: {places}")
    if not (bool((hit.t == F32_MAX).all()) and bool((hit.prim == -1).all())
            and bool((hit.shape == -1).all()) and not bool(hit.valid.any())
            and accum.frame == 0 and not bool(accum.weight.any())):
        raise AssertionError("[api] Hit.none or Accumulator.zeros is not empty")
    keys = {"bytes_in_use", "peak_bytes_in_use", "bytes_reserved", "bytes_limit"}
    if set(stats) != keys or stats["bytes_limit"] != limit:
        raise AssertionError(f"[api] device_memory_stats(index=0) is {stats}, "
                             f"mem_get_info limit {limit}")
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    if [d.kind for d in devices] != names or {d.platform for d in devices} != {"gpu"}:
        raise AssertionError(f"[api] enumerate_devices() does not name the cards {names}")
    if lib is None:
        raise AssertionError("[api] get_lib() did not load the native library")
    if size != nbytes(scene) or size <= 0:
        raise AssertionError(f"[api] buffers.register counted {size} of {nbytes(scene)} bytes")
    if any(counts.values()):
        raise AssertionError(f"[api] the public surface launched kernels: {counts}")
    return counts


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
    phase_counts.update(mesh_phases(scene, camera, device))
    phase_counts["cli"] = cli_phase(device)
    phase_counts.update(bdpt_grad_phases(scene, camera, device))
    phase_counts["viewer"], phase_counts["viewer_glass_gallery"] = viewer_phase(device)
    phase_counts["checkpoint"] = checkpoint_phase(device)
    phase_counts["profiler"] = profiler_phase(device)
    with torch.no_grad():
        phase_counts.update(accel_phases(scene, camera, device))
        bunny_paths, bunny_counts = bunny_phases(device)
    paths.update(bunny_paths)
    phase_counts.update(bunny_counts)
    phase_counts["api"] = api_phase(scene, device)
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
