"""Shading in the PyTorch port against the JAX package: surface interaction,
material fetch, the uber BSDF, the BxDF building blocks and light sampling,
given the same hits and the same uniforms.

The scene is a material zoo built by both packages from the same numpy
arrays: diffuse, glossy (Trowbridge-Reitz), conductor, Fresnel-blend,
glass, a half-transparent pass-through lobe and an emitter, lit by mesh,
disk, point and directional lights.  Hits come from the JAX package's
brute-force oracle and are handed to both.  Tolerance: allclose at rtol =
atol = 1e-5, float32 formulas in the same order with last-bit differences
in transcendental functions and in reductions compounded over a few steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu.accel.brute import intersect_brute
from mcrt_tpu.bsdf import bxdfs as jbx
from mcrt_tpu.bsdf import materials as jmat
from mcrt_tpu.bsdf import uber as juber
from mcrt_tpu.camera.pinhole import PinholeCamera as JCamera
from mcrt_tpu.core import math as jm
from mcrt_tpu.core.types import Rays as JRays
from mcrt_tpu.lights import lights as jlt
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.scene import interaction as jint
from mcrt_tpu.sampling.samplers import uniform_sphere
from mcrt_tpu.scene import scene as jsc
from mcrt_tpu_torch.bsdf import bxdfs as tbx
from mcrt_tpu_torch.bsdf import materials as tmat
from mcrt_tpu_torch.bsdf import uber as tuber
from mcrt_tpu_torch.core.types import Hit, RayDiff, Rays
from mcrt_tpu_torch.lights import lights as tlt
from mcrt_tpu_torch.scene import builders as tbuild
from mcrt_tpu_torch.scene import interaction as tint
from mcrt_tpu_torch.scene import scene as tsc
from tests.test_torch_blocked import port_scene

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N = 2048


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, msg=""):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), **TOL, err_msg=msg)


ZOO_MATERIALS = [
    dict(diffuse=(0.6, 0.55, 0.5)),
    dict(glossy=(0.9, 0.75, 0.4), roughness=0.08),
    dict(kr=(0.95, 0.64, 0.54), conductor_eta=(0.2, 0.92, 1.1),
         conductor_k=(3.9, 2.45, 2.14)),
    dict(diffuse=(0.3, 0.4, 0.2), rs_blend=(0.05, 0.05, 0.05), roughness=0.3),
    dict(kt=(0.95, 0.95, 0.95), kr=(0.1, 0.1, 0.1), ior=1.5, roughness=0.0),
    dict(diffuse=(0.5, 0.2, 0.2), opacity=(0.5, 0.5, 0.5)),
    dict(glossy=(0.4, 0.45, 0.8), diffuse=(0.1, 0.1, 0.25), roughness=0.25),
    dict(),  # emitter
]


def _zoo(pkg, **device):
    """The zoo scene built by ``pkg``'s own builders (``jb``/``jsc`` or
    ``tbuild``/``tsc``, the latter with ``device``)."""
    builders, scene_mod = pkg
    sb = builders.SceneBuffers()
    fp, fi = builders.quad([-6, 0, 6], [6, 0, 6], [6, 0, -6], [-6, 0, -6])
    sb.add_mesh(fp, fi, 0)
    for k in range(1, 7):
        p, idx, n = builders.icosphere(((k - 3.5) * 1.5, 0.7, 0.3 * (k % 2)), 0.65, subdiv=2)
        sb.add_mesh(p, idx, k, normals=n)
    lp, li = builders.quad([-1, 3.5, -1], [1, 3.5, -1], [1, 3.5, 1], [-1, 3.5, 1])
    light_shape = sb.add_mesh(lp, li, 7, light_id=0)
    positions, normals, uvs, indices, face_shape, shape_mat, shape_light = sb.concat()
    host_lights = [
        {"type": scene_mod.LIGHT_MESH, "intensity": (14.0, 13.0, 12.0), "shape": light_shape},
        {"type": scene_mod.LIGHT_DISK, "position": (2.0, 3.0, 2.0),
         "direction": (-0.3, -1.0, -0.2), "radius": 0.5, "intensity": (5.0, 5.0, 6.0)},
        {"type": scene_mod.LIGHT_POINT, "position": (-2.0, 2.5, 1.5), "intensity": (8.0, 7.0, 6.0)},
        {"type": scene_mod.LIGHT_DIRECTIONAL, "direction": (0.4, -1.0, -0.3),
         "intensity": (1.0, 0.9, 0.8)},
    ]
    lights = scene_mod.make_lights(host_lights, positions, indices, face_shape, **device)
    mats = [scene_mod.UberMaterial(**kw) for kw in ZOO_MATERIALS]
    return scene_mod.build_scene(positions, normals, uvs, indices, face_shape, shape_mat,
                                 mats, lights=lights, shape_light=shape_light, **device)


@pytest.fixture(scope="module")
def zoo():
    """(jax scene, port scene from interop, jax rays, port rays, jax hit,
    port hit, jax diff, port diff, uniforms)."""
    jscene = _zoo((jb, jsc))
    tscene = port_scene(jscene)
    cam = JCamera.look_at(eye=(0.0, 2.5, 8.0), target=(0.0, 0.7, 0.0), fov_deg=50.0)
    rng = np.random.default_rng(2024)
    uv = rng.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    o, d = cam.generate_rays(jnp.asarray(uv))
    o = jnp.broadcast_to(o, d.shape)
    jrays = JRays.make(o, d)
    jdiff = cam.generate_ray_differentials(jnp.asarray(uv), 64, 64)
    jhit = intersect_brute(jscene.geometry, jrays)
    trays = Rays(**{k: _t(getattr(jrays, k)) for k in ("o", "d", "tmin", "tmax", "active")})
    thit = Hit(**{k: _t(getattr(jhit, k)) for k in ("t", "prim", "shape", "u", "v", "valid")})
    tdiff = RayDiff(dddx=_t(jdiff.dddx), dddy=_t(jdiff.dddy))
    u = rng.uniform(0.0, 1.0, (N, 8)).astype(np.float32)
    return jscene, tscene, jrays, trays, jhit, thit, jdiff, tdiff, u


def test_zoo_hits_every_material(zoo):
    jscene, _, _, _, jhit, *_ = zoo
    mats = np.asarray(jscene.shapes.material)[np.asarray(jhit.shape)[np.asarray(jhit.valid)]]
    assert set(mats.tolist()) >= set(range(7))


def test_port_builders_build_the_same_scene(zoo):
    jscene, tscene = zoo[0], zoo[1]
    own = _zoo((tbuild, tsc), device="cpu")
    for group in ("geometry", "shapes", "materials", "lights"):
        for name, field in vars(getattr(tscene, group)).items():
            if isinstance(field, torch.Tensor):
                np.testing.assert_array_equal(getattr(getattr(own, group), name).numpy(),
                                              field.numpy(), err_msg=f"{group}.{name}")
    assert own.materials.used_lobes == tscene.materials.used_lobes \
        == tuple(jscene.materials.used_lobes)
    assert own.lights.num == tscene.lights.num == int(jscene.lights.num)
    _close(own.center, jscene.center)
    _close(own.radius, jscene.radius)


def _interactions(zoo):
    jscene, tscene, jrays, trays, jhit, thit, jdiff, tdiff, _ = zoo
    return (jint.compute_interaction(jscene, jrays, jhit, diff=jdiff),
            tint.compute_interaction(tscene, trays, thit, diff=tdiff))


def test_compute_interaction_matches_jax(zoo):
    ji, ti = _interactions(zoo)
    for name in ("p", "ng", "ns", "dpdu", "dpdv", "uv", "wo", "duvdx", "duvdy"):
        _close(getattr(ti, name), getattr(ji, name), name)
    for name in ("material", "light", "valid"):
        np.testing.assert_array_equal(getattr(ti, name).numpy(), np.asarray(getattr(ji, name)))


def test_fetch_bsdf_matches_jax(zoo):
    ji, ti = _interactions(zoo)
    jb_, _ = jmat.fetch_bsdf(zoo[0], ji)
    tb_, _ = tmat.fetch_bsdf(zoo[1], ti)
    for name in ("diffuse", "glossy", "kr", "kt", "passthrough", "alpha", "eta",
                 "conductor_eta", "conductor_k", "rs_blend"):
        _close(getattr(tb_, name), getattr(jb_, name), name)
    assert tb_.used == tuple(jb_.used) and all(tb_.used)
    np.testing.assert_array_equal(tb_.lobe_masks().numpy(), np.asarray(jb_.lobe_masks()))


def _local_dirs(zoo):
    ji, ti = _interactions(zoo)
    u = zoo[-1]
    wo = jm.to_local(ji.dpdu, ji.dpdv, ji.ns, ji.wo)
    wi = uniform_sphere(jnp.asarray(u[:, 3:5]))
    return ji, ti, np.asarray(wo), np.asarray(wi)


def test_uber_evaluate_pdf_sample_match_jax(zoo):
    ji, ti, wo, wi = _local_dirs(zoo)
    jbsdf, _ = jmat.fetch_bsdf(zoo[0], ji)
    tbsdf, _ = tmat.fetch_bsdf(zoo[1], ti)
    u3 = zoo[-1][:, 0:3]
    _close(tuber.evaluate(tbsdf, _t(wo), _t(wi)),
           juber.evaluate(jbsdf, jnp.asarray(wo), jnp.asarray(wi)), "evaluate")
    _close(tuber.pdf(tbsdf, _t(wo), _t(wi)),
           juber.pdf(jbsdf, jnp.asarray(wo), jnp.asarray(wi)), "pdf")
    js = juber.sample(jbsdf, jnp.asarray(wo), jnp.asarray(u3))
    ts = tuber.sample(tbsdf, _t(wo), _t(u3))
    for name in ("valid", "is_specular", "is_transmission"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("wi", "f", "pdf"):
        _close(getattr(ts, name), getattr(js, name), name)


def _scan_pick(msk, u):
    """The lobe pick as a prefix count of the masks: a lane's c-th present
    lobe is the first whose rank (present lobes before it) is c."""
    num_i = torch.sum(msk.to(torch.int32), dim=-1)
    num = torch.clamp_min(num_i, 1).to(torch.float32)
    c = torch.minimum((u * num).to(torch.int32), num_i - 1)
    return _scan_nth(msk, c), num_i, num


def _scan_nth(msk, c):
    mski = msk.to(torch.int32)
    rank = torch.cumsum(mski, dim=-1) - mski
    return torch.argmax((msk & (rank == c[..., None])).to(torch.int32), dim=-1)


@pytest.mark.parametrize("code", range(1 << tuber.N_LOBES))
def test_lobe_tables_equal_the_prefix_count(code):
    """Every mask pattern, with every c from -1 (no lobe) to 4, picks the
    lobe and counts the lobes as the prefix count does."""
    c = torch.arange(-1, tuber.N_LOBES, dtype=torch.int32)
    msk = torch.tensor([bool(code >> k & 1) for k in range(tuber.N_LOBES)]).expand(len(c), -1)
    packed = tuber.lobe_code(msk)
    assert packed.tolist() == [code] * len(c)
    lobe = tuber.nth_lobe(packed, c)
    np.testing.assert_array_equal(lobe.numpy(), _scan_nth(msk, c).numpy())
    _, num_i, _ = tuber.pick_lobe(msk, torch.zeros(len(c)))
    np.testing.assert_array_equal(num_i.numpy(), torch.sum(msk.to(torch.int32), dim=-1).numpy())
    assert lobe.dtype == num_i.dtype == torch.int32


def test_uber_sample_equals_the_prefix_count_pick(zoo, monkeypatch):
    """``sample`` on the zoo gives bit-equal outputs with the prefix-count
    pick in place of the table pick, including on lanes with no lobe."""
    _, ti, wo, _ = _local_dirs(zoo)
    tbsdf, _ = tmat.fetch_bsdf(zoo[1], ti)
    u3 = _t(zoo[-1][:, 0:3])
    assert bool((tbsdf.num_lobes() == 0).any()) and bool((tbsdf.num_lobes() > 1).any())
    got = tuber.sample(tbsdf, _t(wo), u3)
    monkeypatch.setattr(tuber, "pick_lobe", _scan_pick)
    want = tuber.sample(tbsdf, _t(wo), u3)
    for name in ("wi", "f", "pdf", "valid", "is_specular", "is_transmission"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("dist", [jbx.TROWBRIDGE_REITZ, jbx.BECKMANN])
def test_bxdf_building_blocks_match_jax(dist):
    rng = np.random.default_rng(dist + 3)
    n = 1024

    def unit():
        v = rng.normal(size=(n, 3)).astype(np.float32)
        v[:, 1] = np.abs(v[:, 1])
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    wo, wi = unit(), unit()
    wt = wi * np.asarray([1.0, -1.0, 1.0], np.float32)  # the other hemisphere
    alpha = rng.uniform(0.02, 0.9, n).astype(np.float32)
    eta = rng.uniform(1.1, 2.0, n).astype(np.float32)
    col = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    u2 = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    cos_i = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    one = np.ones_like(eta)
    cases = [
        ("mf_sample_wh", lambda mod, a: mod.mf_sample_wh(a(wo), a(u2), a(alpha), dist)),
        ("mf_d", lambda mod, a: mod.mf_d(a(wo), a(alpha), dist)),
        ("mf_g", lambda mod, a: mod.mf_g(a(wo), a(wi), a(alpha), dist)),
        ("microfacet_reflection_f", lambda mod, a: mod.microfacet_reflection_f(
            a(col), a(alpha), a(one), a(eta), a(wo), a(wi), dist)),
        ("microfacet_reflection_pdf", lambda mod, a: mod.microfacet_reflection_pdf(
            a(wo), a(wi), a(alpha), dist)),
        ("fresnel_blend_f", lambda mod, a: mod.fresnel_blend_f(
            a(col), a(col * 0.1), a(alpha), a(wo), a(wi), dist)),
        ("fresnel_dielectric", lambda mod, a: mod.fresnel_dielectric(a(cos_i), a(one), a(eta))),
        ("fresnel_conductor", lambda mod, a: mod.fresnel_conductor(
            a(np.abs(cos_i)), a(col + 0.2), a(col * 3.0))),
        ("refract_local", lambda mod, a: mod.refract_local(a(wo), a(1.0 / eta))),
        ("roughness_to_alpha", lambda mod, a: mod.roughness_to_alpha(a(alpha))),
        ("mf_g1", lambda mod, a: mod.mf_g1(a(wi), a(alpha), dist)),
        ("oren_nayar_f", lambda mod, a: mod.oren_nayar_f(a(col), a(alpha * 40.0), a(wo), a(wi))),
        ("microfacet_transmission_f", lambda mod, a: mod.microfacet_transmission_f(
            a(col), a(alpha), a(one), a(eta), a(wo), a(wt), dist=dist)),
        ("microfacet_transmission_pdf", lambda mod, a: mod.microfacet_transmission_pdf(
            a(wo), a(wt), a(alpha), a(one), a(eta), dist)),
    ]
    for name, fn in cases:
        j = fn(jbx, jnp.asarray)
        t = fn(tbx, _t)
        for a, b in zip(t if isinstance(t, tuple) else (t,), j if isinstance(j, tuple) else (j,)):
            if b.dtype == bool:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
            elif name.startswith("microfacet_transmission"):
                # divides by (wo.wh + eta wi.wh)^2, which is near 0 for some
                # random pairs and amplifies last-bit differences of the
                # half vector: rtol 1e-4 there
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                           err_msg=name)
            else:
                _close(a, b, name)


def test_light_sampling_matches_jax(zoo):
    jscene, tscene = zoo[0], zoo[1]
    ji, ti = _interactions(zoo)
    u = zoo[-1]
    jidx, jchoice = jlt.pick_light(jscene.lights, jnp.asarray(u[:, 5]))
    tidx, tchoice = tlt.pick_light(tscene.lights, _t(u[:, 5]))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tchoice, jchoice)
    assert set(tidx.numpy().tolist()) == {0, 1, 2, 3}
    js = jlt.sample_li(jscene, jidx, ji.p, jnp.asarray(u[:, 6:8]))
    ts = tlt.sample_li(tscene, tidx, ti.p, _t(u[:, 6:8]))
    for name in ("valid", "is_delta"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    for name in ("li", "wi", "pdf", "dist", "p", "n"):
        _close(getattr(ts, name), getattr(js, name), name)
    _close(tlt.pdf_li(tscene, tidx, ti.p, ts.wi, ts.p, ts.n),
           jlt.pdf_li(jscene, jidx, ji.p, js.wi, js.p, js.n), "pdf_li")
    _close(tlt.eval_le(tscene, ti.light, ti.ns, ti.wo),
           jlt.eval_le(jscene, ji.light, ji.ns, ji.wo), "eval_le")
    jsr = jint.spawn_shadow_ray(ji, js.wi, js.dist, 1e-4, js.valid)
    tsr = tint.spawn_shadow_ray(ti, ts.wi, ts.dist, 1e-4, ts.valid)
    for name in ("o", "d", "tmin", "tmax"):
        _close(getattr(tsr, name), getattr(jsr, name), name)
    jr = jint.spawn_ray(ji, js.wi, 1e-4, 1e6, ji.valid)
    tr = tint.spawn_ray(ti, ts.wi, 1e-4, 1e6, ti.valid)
    for name in ("o", "d", "tmin", "tmax"):
        _close(getattr(tr, name), getattr(jr, name), name)

