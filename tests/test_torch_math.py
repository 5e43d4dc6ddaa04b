"""The PyTorch port against the JAX package: core math, sampling warps,
filters, the frame jitter, the Morton pixel order and the pinhole camera.

Inputs come from numpy with a fixed seed and go to both packages.  Unless a
test says otherwise the tolerance is allclose at rtol = atol = 1e-6: both
sides evaluate the same float32 formulas in the same order, and 1e-6 leaves
room only for the last-bit differences of transcendental functions
(sqrt, rsqrt, sin, cos) between XLA's and PyTorch's CPU implementations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu import renderer as jrend
from mcrt_tpu.camera import pinhole as jcam
from mcrt_tpu.config import FilterConfig as JFilterConfig
from mcrt_tpu.config import FilterType as JFilterType
from mcrt_tpu.core import math as jm
from mcrt_tpu.film import accumulate as jacc
from mcrt_tpu.film import filters as jfilt
from mcrt_tpu.sampling import samplers as jsmp
from mcrt_tpu_torch import renderer as trend
from mcrt_tpu_torch.camera import pinhole as tcam
from mcrt_tpu_torch.config import FilterConfig, FilterType
from mcrt_tpu_torch.core import math as tm
from mcrt_tpu_torch.film import accumulate as tacc
from mcrt_tpu_torch.film import filters as tfilt
from mcrt_tpu_torch.sampling import samplers as tsmp

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
RNG = np.random.default_rng(20240611)


def _vec(n=257, k=3):
    return RNG.normal(size=(n, k)).astype(np.float32)


def _unit(n=257):
    v = _vec(n)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _uniform(n=257, k=2):
    return RNG.uniform(0.0, 1.0, (n, k)).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    out_j = fn_j(*[jnp.asarray(a) for a in arrays])
    out_t = fn_t(*[torch.from_numpy(np.array(a)) for a in arrays])
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    return [np.asarray(a) for a in out_j], [b.numpy() for b in out_t]


MATH_CASES = {
    "dot": (jm.dot, tm.dot, lambda: (_vec(), _vec())),
    "cross": (jm.cross, tm.cross, lambda: (_vec(), _vec())),
    "normalize": (jm.normalize, tm.normalize, lambda: (_vec(),)),
    "length": (jm.length, tm.length, lambda: (_vec(),)),
    "reflect": (jm.reflect, tm.reflect, lambda: (_unit(), _unit())),
    "faceforward": (jm.faceforward, tm.faceforward, lambda: (_unit(), _vec())),
    "orthogonal_vector": (jm.orthogonal_vector, tm.orthogonal_vector, lambda: (_unit(),)),
    "build_orthonormal_basis": (jm.build_orthonormal_basis,
                                tm.build_orthonormal_basis, lambda: (_unit(),)),
    "to_local": (jm.to_local, tm.to_local, lambda: (_unit(), _unit(), _unit(), _vec())),
    "to_world": (jm.to_world, tm.to_world, lambda: (_unit(), _unit(), _unit(), _vec())),
    "lerp_direction": (jm.lerp_direction, tm.lerp_direction,
                       lambda: (*(_unit(1)[0] for _ in range(4)), _uniform())),
    "solve_2x2": (jm.solve_2x2, tm.solve_2x2, lambda: tuple(_vec(257, 1)[:, 0] for _ in range(6))),
    "safe_div": (jm.safe_div, tm.safe_div,
                 lambda: (_vec(257, 1)[:, 0], np.where(RNG.random(257) < 0.2, 0.0,
                                                       _vec(257, 1)[:, 0]).astype(np.float32))),
    "luminance": (jm.luminance, tm.luminance, lambda: (np.abs(_vec()),)),
    "is_black": (jm.is_black, tm.is_black,
                 lambda: (np.where(RNG.random((257, 1)) < 0.5, 0.0, _vec()).astype(np.float32),)),
    "concentric_disk": (jsmp.concentric_disk, tsmp.concentric_disk, lambda: (_uniform(),)),
    "cosine_hemisphere": (jsmp.cosine_hemisphere, tsmp.cosine_hemisphere, lambda: (_uniform(),)),
    "uniform_hemisphere": (jsmp.uniform_hemisphere, tsmp.uniform_hemisphere, lambda: (_uniform(),)),
    "uniform_sphere": (jsmp.uniform_sphere, tsmp.uniform_sphere, lambda: (_uniform(),)),
    "uniform_triangle": (jsmp.uniform_triangle, tsmp.uniform_triangle, lambda: (_uniform(),)),
    "uniform_cone": (jsmp.uniform_cone, tsmp.uniform_cone,
                     lambda: (_uniform(), _uniform(257, 1)[:, 0])),
    "power_heuristic": (lambda a, b: jsmp.power_heuristic(1.0, a, 1.0, b),
                        lambda a, b: tsmp.power_heuristic(1.0, a, 1.0, b),
                        lambda: (np.abs(_vec(257, 1)[:, 0]), np.abs(_vec(257, 1)[:, 0]))),
    "balance_heuristic": (lambda a, b: jsmp.balance_heuristic(2.0, a, 1.0, b),
                          lambda a, b: tsmp.balance_heuristic(2.0, a, 1.0, b),
                          lambda: (np.abs(_vec(257, 1)[:, 0]), np.abs(_vec(257, 1)[:, 0]))),
    "uniform_cone_pdf": (jsmp.uniform_cone_pdf, tsmp.uniform_cone_pdf,
                         lambda: (_uniform(257, 1)[:, 0],)),
    "transform_point": (jm.transform_point, tm.transform_point,
                        lambda: (_vec(4, 4), _vec())),
    "transform_vector": (jm.transform_vector, tm.transform_vector,
                         lambda: (_vec(4, 4), _vec())),
    "transform_normal": (jm.transform_normal, tm.transform_normal,
                         lambda: (_vec(4, 4), _vec())),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math_and_warps_match_jax(name):
    fn_j, fn_t, make = MATH_CASES[name]
    outs_j, outs_t = _both(fn_j, fn_t, *make())
    for a, b in zip(outs_j, outs_t):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, **TOL)


def test_constant_pdfs_match_jax():
    for name in ("uniform_hemisphere_pdf", "uniform_sphere_pdf"):
        np.testing.assert_allclose(getattr(tsmp, name)(), float(getattr(jsmp, name)()),
                                   **TOL, err_msg=name)


def test_config_copy_matches_jax():
    """The port's config is a field-for-field copy: the same dict for the
    same non-default values, and ``from_dict`` round-trips."""
    from mcrt_tpu import config as jconfig
    from mcrt_tpu_torch import config as tconfig

    d = {"width": 40, "height": 24, "spp": 3, "accel": "blocked",
         "integrator": {"max_depth": 5, "use_mis": True, "rr_start_depth": 2},
         "sampler": {"type": "sobol", "seed": 7}, "filter": {"type": "gaussian"},
         "bvh": {"builder": "lbvh", "sah_bins": 12}, "sharding": {"mesh_shape": [2, 1]}}
    t = tconfig.from_dict(d)
    assert tconfig.to_dict(t) == jconfig.to_dict(jconfig.from_dict(d))
    assert tconfig.from_dict(tconfig.to_dict(t)) == t
    assert tconfig.to_dict(tconfig.RenderConfig()) == jconfig.to_dict(jconfig.RenderConfig())


@pytest.mark.parametrize("ftype", list(FilterType))
def test_filters_match_jax(ftype):
    off = RNG.uniform(-1.0, 1.0, (301, 2)).astype(np.float32)
    jw = jfilt.eval_filter(JFilterConfig(type=JFilterType(ftype.value), radius=0.75),
                           jnp.asarray(off))
    tw = tfilt.eval_filter(FilterConfig(type=ftype, radius=0.75), torch.from_numpy(off))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)


def test_accumulate_matches_jax():
    h, w = 6, 5
    ja = jacc.Accumulator.zeros(w, h)
    ta = tacc.Accumulator.zeros(w, h)
    for f in range(3):
        rad = (RNG.uniform(-1.0, 1.5, (h * w, 3)) * 1500.0).astype(np.float32)
        jit = np.array(jrend.frame_jitter(jnp.asarray(f)))
        ja = jacc.accumulate(ja, jnp.asarray(rad), jnp.asarray(jit), JFilterConfig(
            type=JFilterType.GAUSSIAN), 1000.0)
        ta = tacc.accumulate(ta, torch.from_numpy(rad), torch.from_numpy(jit),
                             FilterConfig(type=FilterType.GAUSSIAN), 1000.0)
    assert ta.frame == int(ja.frame) == 3
    np.testing.assert_allclose(ta.image.numpy(), np.asarray(ja.image), **TOL)


@pytest.mark.parametrize("frame", [0, 1, 2, 7, 63, 1000, 123457])
def test_frame_jitter_is_bit_equal(frame):
    j = np.asarray(jrend.frame_jitter(jnp.asarray(frame, jnp.int32)))
    t = trend.frame_jitter(frame, device="cpu").numpy()
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


@pytest.mark.parametrize("wh", [(1, 1), (16, 16), (37, 23), (64, 48)])
def test_morton_pixel_order_equal(wh):
    jo, ji = jrend._morton_pixel_order(*wh)
    to, ti = trend.morton_pixel_order(*wh)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ti, ji)


def test_pixel_uv_and_camera_rays_match_jax():
    w, h = 24, 17
    kw = dict(eye=(0.3, 1.1, 3.4), target=(0.0, 0.9, 0.0), fov_deg=41.0,
              aspect=w / h)
    jc = jcam.PinholeCamera.look_at(**kw)
    tc = tcam.PinholeCamera.look_at(**kw, device="cpu")
    for name in ("position", "c00", "c10", "c01", "c11", "forward", "area",
                 "tan_half_fov", "right", "up"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), **TOL, err_msg=name)
    jit = np.asarray([0.21, -0.37], np.float32)
    juv = jcam.pixel_uv(w, h, jitter=jnp.asarray(jit)[None, :])
    tuv = tcam.pixel_uv(w, h, jitter=torch.from_numpy(jit)[None, :], device="cpu")
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), **TOL)
    jo, jd = jc.generate_rays(juv)
    to, td = tc.generate_rays(tuv)
    np.testing.assert_allclose(to.numpy(), np.broadcast_to(np.asarray(jo), to.shape), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    jdiff = jc.generate_ray_differentials(juv, w, h)
    tdiff = tc.generate_ray_differentials(tuv, w, h)
    np.testing.assert_allclose(tdiff.dddx.numpy(), np.asarray(jdiff.dddx), **TOL)
    np.testing.assert_allclose(tdiff.dddy.numpy(), np.asarray(jdiff.dddy), **TOL)
