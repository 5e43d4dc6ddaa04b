"""The port's BDPT against the JAX package's on more scenes than
``cornell_box`` (the harness of ``tests/test_torch_bdpt.py``: 16x16
jittered camera rays from a numpy seed handed to both packages).

- ``glass_gallery`` (depth 3, Sobol; the JAX side on its
  brute-force oracle) and ``instanced_boxes`` (depth 3, Sobol; the JAX side
  on ``AUTO``, its two-level kernels in interpret mode): at least 99% of
  pixels within rtol 1e-3 / atol 1e-4, the image means within 1e-4
  relative, the criterion of ``test_trace_matches_jax``.
- ``textured_hall`` (depth 3, Sobol), held to criteria that follow from
  the cause of its per-pixel disagreement.  An opaque texture's bilinear
  alpha sums to 1 minus 1-2 ulp on some lanes, which leaves a passthrough
  lobe of about 6e-8 that ``lobe_masks`` counts as present; the packages'
  last-bit rounding (XLA against torch) moves a lane across that residue,
  and the lobe pick turns on it.  So:

  * the camera and light subpaths' vertices agree per field (``VERTEX_TOL``;
    integer and flag fields equal) on every valid vertex of every lane up
    to the first vertex where the two packages' lobe counts differ, that
    vertex's own record included (its reverse pdf of the previous vertex
    and everything after it excluded);
  * at that vertex, the passthrough of each package is at most 1.2e-7;
  * the converged BDPT means (128 samples a pixel, each sample with the
    same jitter and RANDOM stream in both packages) are within
    ``CONVERGED_REL`` relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu.accel import build_intersector as j_build_intersector
from mcrt_tpu.accel.brute import intersect_brute, occluded_brute
from mcrt_tpu.camera.pinhole import pixel_uv as j_pixel_uv
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import RenderConfig as JRenderConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.core.types import Rays as JRays
from mcrt_tpu.integrators import bdpt as jbdpt
from mcrt_tpu.sampling import rng as jrng
from mcrt_tpu.scene import builders as jb
from mcrt_tpu_torch.accel import build_intersector
from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig, SamplerConfig, SamplerType
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.integrators import bdpt
from mcrt_tpu_torch.sampling import rng
from tests.test_torch_bdpt import MIN_AGREE
from tests.test_torch_blocked import port_scene
from tests.test_torch_render import _camera

torch.set_num_threads(1)

W = 16
N = W * W
DEPTH = 3
PASSTHROUGH_RESIDUE = 1.2e-7
CONVERGED_SPP = 128
CONVERGED_BATCH = 64  # copies of the film a wavefront
CONVERGED_REL = 1e-4
# (rtol, atol) per float field of ``Vertices``
VERTEX_TOL = {"p": (1e-4, 2e-4), "ng": (0.0, 0.0), "ns": (1e-4, 1e-3), "t": (1e-4, 1e-3),
              "b": (1e-4, 1e-5), "uv": (1e-4, 2e-4), "wo": (1e-4, 2e-4),
              "beta": (1e-2, 1e-5), "pdf_fwd": (1e-3, 1e-6), "pdf_rev": (2e-3, 1e-6)}


def _jittered_rays(jcam):
    jit = np.random.default_rng(0).uniform(-0.5, 0.5, (N, 2)).astype(np.float32)
    o, d = jcam.generate_rays(j_pixel_uv(W, W, jitter=jnp.asarray(jit)))
    return np.asarray(o), np.asarray(d)


def _jax_queries(jscene, accel):
    if accel == JAccelType.BRUTE:
        return (lambda s, r: intersect_brute(s.geometry, r),
                lambda s, r: occluded_brute(s.geometry, r))
    isect = j_build_intersector(jscene, JRenderConfig(width=W, height=W, accel=accel))
    return isect.intersect, isect.occluded


@pytest.mark.parametrize("name, sampler, accel", [
    ("glass_gallery", "SOBOL", JAccelType.BRUTE),
    ("instanced_boxes", "SOBOL", JAccelType.AUTO)])
def test_trace_matches_jax(name, sampler, accel):
    jscene, jcam = getattr(jb, name)()
    tscene, tcam = port_scene(jscene), _camera(jcam)
    o, d = _jittered_rays(jcam)
    jint, jocc = _jax_queries(jscene, accel)
    jstream = jrng.make_stream(JSamplerConfig(type=JSamplerType[sampler]), jnp.asarray(0),
                               jnp.arange(N))
    jimg = np.asarray(jax.jit(lambda s: jbdpt.trace(
        s, jcam, JRays.make(jnp.asarray(o), jnp.asarray(d)), jstream,
        JIntegratorConfig(max_depth=DEPTH), jint, jocc))(jscene))
    isect = build_intersector(tscene, RenderConfig(width=W, height=W))
    tstream = rng.make_stream(SamplerConfig(type=SamplerType[sampler]), 0, torch.arange(N))
    with torch.no_grad():
        timg = bdpt.trace(tscene, tcam, Rays.make(torch.from_numpy(o), torch.from_numpy(d)),
                          tstream, IntegratorConfig(max_depth=DEPTH), isect.intersect,
                          isect.occluded).numpy()
    share = np.isclose(timg, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    print(f"{name} {sampler}: agreeing share {share:.4f}, means {timg.mean():.7f} / "
          f"{jimg.mean():.7f}")
    assert np.isfinite(timg).all() and timg.mean() > 0.0
    assert share >= MIN_AGREE
    assert abs(timg.mean() - jimg.mean()) <= 1e-4 * jimg.mean()


@pytest.fixture(scope="module")
def hall():
    jscene, jcam = jb.textured_hall()
    return (jscene, jcam), (port_scene(jscene), _camera(jcam))


def _subpaths_both(hall):
    """Both packages' camera and light subpaths of the jittered rays, with
    each vertex's lobe count and passthrough: {"camera": (port, jax),
    "light": (port, jax)}, each a (Vertices, (N, V) counts, (N, V, 3)
    passthrough)."""
    (jscene, jcam), (tscene, tcam) = hall
    o, d = _jittered_rays(jcam)
    jint = _jax_queries(jscene, JAccelType.BRUTE)[0]
    jcfg = JIntegratorConfig(max_depth=DEPTH)
    jstream = jrng.make_stream(JSamplerConfig(type=JSamplerType.SOBOL), jnp.asarray(0),
                               jnp.arange(N))

    @jax.jit
    def jsub(s):
        cam, st, cb = jbdpt.generate_camera_subpath(
            s, jcam, JRays.make(jnp.asarray(o), jnp.asarray(d)), jstream, DEPTH + 2, jcfg,
            jint)
        light, _, lb = jbdpt.generate_light_subpath(s, st, DEPTH + 1, jcfg, jint, N)
        return (cam, cb.num_lobes(), cb.passthrough), (light, lb.num_lobes(), lb.passthrough)

    jout = jsub(jscene)
    isect = build_intersector(tscene, RenderConfig(width=W, height=W))
    cfg = IntegratorConfig(max_depth=DEPTH)
    tstream = rng.make_stream(SamplerConfig(type=SamplerType.SOBOL), 0, torch.arange(N))
    with torch.no_grad():
        cam, st, cb = bdpt.generate_camera_subpath(
            tscene, tcam, Rays.make(torch.from_numpy(o), torch.from_numpy(d)), tstream,
            DEPTH + 2, cfg, isect.intersect)
        light, _, lb = bdpt.generate_light_subpath(tscene, st, DEPTH + 1, cfg,
                                                   isect.intersect, N)

    def stacked(bsdfs):
        return (torch.stack([b.num_lobes() for b in bsdfs], 1).numpy(),
                torch.stack([b.passthrough for b in bsdfs], 1).numpy())

    return {"camera": ((cam,) + stacked(cb), jout[0]),
            "light": ((light,) + stacked(lb), jout[1])}


def test_textured_hall_subpaths_agree_up_to_the_lobe_count_flip(hall):
    flips = 0
    for name, ((tv, tn, tpass), (jv, jn, jpass)) in _subpaths_both(hall).items():
        jn, jpass = np.asarray(jn), np.asarray(jpass)
        n_verts = tn.shape[1]
        differ = tn != jn
        first = np.where(differ.any(1), differ.argmax(1), n_verts)  # (N,)
        lanes = np.nonzero(first < n_verts)[0]
        flips += len(lanes)
        # the flip turns on the residue: both passthroughs at most 1.2e-7
        for p in (tpass, jpass):
            assert (p[lanes, first[lanes]] <= PASSTHROUGH_RESIDUE).all(), name
        upto = np.arange(n_verts)[None, :] <= first[:, None]  # (N, V)
        valid = tv.valid.numpy()
        np.testing.assert_array_equal(valid[upto], np.asarray(jv.valid)[upto])
        for f in dataclasses.fields(tv):
            a, b = getattr(tv, f.name).numpy(), np.asarray(getattr(jv, f.name))
            mask = upto & valid
            if f.name == "pdf_rev":  # set from the next vertex's lobe mixture
                mask = mask & (np.arange(n_verts)[None, :] < first[:, None] - 1)
            if f.name == "delta":  # set from the previous vertex's lobe pick
                mask = mask & (np.arange(n_verts)[None, :] <= first[:, None] - 1)
            a, b = a[mask], b[mask]
            if a.dtype == np.bool_ or a.dtype.kind == "i":
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {f.name}")
            else:
                rtol, atol = VERTEX_TOL[f.name]
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                           err_msg=f"{name} {f.name}")
        print(f"{name} subpath: {len(lanes)} lanes flip a lobe count, at vertices "
              f"{first[lanes].tolist()}")
    assert flips > 0  # the mechanism this test is about is present


def _converged(trace_fn, base, seed):
    """Mean of ``CONVERGED_SPP`` BDPT samples a pixel, traced
    ``CONVERGED_BATCH`` copies of the film a wavefront with numpy jitter."""
    gen = np.random.default_rng(seed)
    acc = np.zeros((N, 3), np.float64)
    for done in range(0, CONVERGED_SPP, CONVERGED_BATCH):
        off = gen.random((CONVERGED_BATCH, N, 2), dtype=np.float32) - 0.5
        uv = ((base + 0.5 + off) / W).reshape(-1, 2).astype(np.float32)
        acc += trace_fn(uv, done).reshape(CONVERGED_BATCH, N, 3).sum(0)
    return acc / CONVERGED_SPP


def test_textured_hall_converged_bdpt_mean_matches_jax(hall):
    (jscene, jcam), (tscene, tcam) = hall
    base = np.stack(np.meshgrid(np.arange(W), np.arange(W), indexing="ij"), -1).reshape(
        N, 2)[:, ::-1].astype(np.float32)  # (col, row), row-major
    lanes = CONVERGED_BATCH * N
    jint, jocc = _jax_queries(jscene, JAccelType.BRUTE)

    @jax.jit
    def jtrace(s, uv, frame):
        o, d = jcam.generate_rays(uv)
        st = jrng.make_stream(JSamplerConfig(), frame, jnp.arange(lanes))
        return jbdpt.trace(s, jcam, JRays.make(o, d), st, JIntegratorConfig(max_depth=DEPTH),
                           jint, jocc, film=(W, W), slot_of_pixel=jnp.arange(N))

    isect = build_intersector(tscene, RenderConfig(width=W, height=W))

    def ttrace(uv, frame):
        o, d = tcam.generate_rays(torch.from_numpy(uv))
        with torch.no_grad():
            return bdpt.trace(tscene, tcam, Rays.make(o, d),
                              rng.make_stream(SamplerConfig(), frame, torch.arange(lanes)),
                              IntegratorConfig(max_depth=DEPTH), isect.intersect,
                              isect.occluded, film=(W, W),
                              slot_of_pixel=torch.arange(N)).numpy()

    j = _converged(lambda uv, f: np.asarray(jtrace(jscene, jnp.asarray(uv), jnp.int32(f))),
                   base, 99)
    t = _converged(ttrace, base, 99)
    rel = abs(t.mean() - j.mean()) / j.mean()
    print(f"converged BDPT means {t.mean():.7f} / {j.mean():.7f}: rel {rel:.3g}")
    assert np.isfinite(t).all()
    assert rel <= CONVERGED_REL
