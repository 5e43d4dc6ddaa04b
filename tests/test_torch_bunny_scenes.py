"""The port's scenes of an OBJ mesh in many copies (``bunny_field``,
``heavy_gallery``, ``bunny_field_instanced``), the two-level loop oracle
and the parameters the port takes as the JAX package does, against the
JAX package on the CPU.

``bunny.obj`` is not in the repository, so the builders read the stand-in
mesh ``chip_smoke.write_standin_obj`` writes (a radially displaced
icosphere), once with ``vn``/``vt`` and once with positions alone.  Scene
tensors are copies of the same numpy arrays, so they must be equal (rtol
0); cameras agree within 1e-6.  Renders are held at ``MIN_AGREE`` of pixels
within rtol 1e-3 / atol 1e-4, ray queries at ``tests/test_two_level.py``'s
criteria (flags equal, t within rtol 1e-5 / atol 1e-5 where valid).  The
renders of the builders' scenes are in ``tests/test_torch_bunny_renders.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcrt_tpu
from chip_smoke import write_standin_obj
from mcrt_tpu import accel as jaccel
from mcrt_tpu.accel import pallas_blocked as jpb
from mcrt_tpu.accel import two_level as jtl
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.core.types import Rays as JRays
from mcrt_tpu.film.accumulate import Accumulator as JAccumulator
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.scene import dynamic as jd
from mcrt_tpu_torch import accel as taccel
from mcrt_tpu_torch.accel import blocked as tb
from mcrt_tpu_torch.accel import two_level as ttl
from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig, SamplerConfig, SamplerType
from mcrt_tpu_torch.core.types import Rays
from mcrt_tpu_torch.film.accumulate import Accumulator
from mcrt_tpu_torch.scene import builders as tbuild
from mcrt_tpu_torch.scene import dynamic as tdyn
from mcrt_tpu_torch.scene.scene import LIGHT_DIRECTIONAL, LIGHT_POINT
from mcrt_tpu_torch.scene.textures import TextureAtlas
from tests.test_torch_blocked import both_rays, port_scene, random_ray_arrays
from tests.test_torch_render import _camera

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

BUILDERS = ("bunny_field", "heavy_gallery", "bunny_field_instanced")
MIN_AGREE = 0.99
LOOP_T_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_two_level.py:139-145
TEXBOX = "tests/assets/texbox.obj"


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """{(subdiv, with vn/vt): path} of stand-in OBJ files."""
    d = tmp_path_factory.mktemp("standin")
    return {(s, a): write_standin_obj(str(d / f"standin_{s}_{int(a)}.obj"), subdiv=s,
                                      attributes=a)
            for s in (1, 2) for a in (True, False)}


def assert_records_equal(own, crossed, where="scene"):
    """Every tensor of two records (nested records included) equal, dtype
    and all; every static field equal."""
    assert type(own).__name__ == type(crossed).__name__, where
    for f in dataclasses.fields(crossed):
        a, b = getattr(own, f.name), getattr(crossed, f.name)
        at = f"{where}.{f.name}"
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, at
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=at)
        elif dataclasses.is_dataclass(b):
            assert_records_equal(a, b, at)
        else:
            assert a == b, at


def assert_cameras_close(own, jcam):
    for field, v in vars(_camera(jcam)).items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(getattr(own, field), v, rtol=1e-6, atol=1e-6, msg=field)


# --------------------------------------------------------------------------
# The builders
# --------------------------------------------------------------------------


@pytest.mark.parametrize("attributes", [True, False], ids=["vn_vt", "bare"])
@pytest.mark.parametrize("name", BUILDERS)
def test_builders_equal_jax(standin, name, attributes):
    """The stand-in at subdiv 1 (80 triangles), grid 2: every tensor of
    geometry, shapes, materials, lights, instances and textures equal to the
    JAX builder's scene, the camera within 1e-6."""
    path = standin[(1, attributes)]
    jscene, jcam = getattr(jb, name)(grid=2, bunny_path=path)
    own, cam = getattr(tbuild, name)(grid=2, bunny_path=path, device="cpu")
    crossed = port_scene(jscene)
    assert_records_equal(own, crossed)
    assert_cameras_close(cam, jcam)
    faces = {"bunny_field": 4 * 80 + 2, "heavy_gallery": 4 * 80 + 4,
             "bunny_field_instanced": 80 + 2}[name]
    assert int(own.geometry.face_valid.sum()) == faces
    if name == "heavy_gallery":  # all four light types, two textures, mirror and glass
        assert sorted(own.lights.type.tolist()) == [0, 1, 2, 3]
        assert isinstance(own.textures, TextureAtlas) and int(own.textures.mips.numel()) == 2
    if name == "bunny_field_instanced":
        assert own.instances.num == 3


def test_asset_path_honours_mcrt_assets(standin, tmp_path, monkeypatch):
    """``_asset_path`` reads ``$MCRT_ASSETS`` in both packages, the builders
    find ``bunny.obj`` there, and a missing file raises
    ``FileNotFoundError`` naming the variable in both; in the port, so does
    a missing variable."""
    (tmp_path / "bunny.obj").write_bytes(open(standin[(1, False)], "rb").read())
    monkeypatch.setenv("MCRT_ASSETS", str(tmp_path))
    assert tbuild._asset_path("bunny.obj") == jb._asset_path("bunny.obj") == \
        str(tmp_path / "bunny.obj")
    own, _ = tbuild.bunny_field(grid=1, device="cpu")
    assert_records_equal(own, port_scene(jb.bunny_field(grid=1)[0]))
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("MCRT_ASSETS", str(empty))
    for fn in (tbuild._asset_path, jb._asset_path):
        with pytest.raises(FileNotFoundError, match="MCRT_ASSETS"):
            fn("bunny.obj")
    for name in BUILDERS:
        with pytest.raises(FileNotFoundError, match="MCRT_ASSETS"):
            getattr(tbuild, name)(grid=1, device="cpu")
    # the port has no default directory: without the variable it raises too
    monkeypatch.delenv("MCRT_ASSETS")
    with pytest.raises(FileNotFoundError, match="MCRT_ASSETS is not set"):
        tbuild._asset_path("bunny.obj")
    with pytest.raises(FileNotFoundError, match="MCRT_ASSETS"):
        tbuild.heavy_gallery(grid=1, device="cpu")


# --------------------------------------------------------------------------
# The two-level loop oracle
# --------------------------------------------------------------------------


def _agreement(a, b):
    """The share of pixels within rtol 1e-3 / atol 1e-4 in every channel."""
    return np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1).mean()


def _grid(pkg, geometry_of, nx=10, nz=10):
    """``tests/test_two_level.py``'s 100-instance grid (an icosphere of
    radius 0.4 at subdiv 1, translated by 1.2 a cell) with ``pkg``'s
    builders: (source geometry, accel)."""
    builders, dyn, two_level = pkg
    pos, idx, _ = builders.icosphere((0.0, 0.0, 0.0), 0.4, subdiv=1)
    sb = builders.SceneBuffers()
    sb.add_mesh(pos, idx, 0)
    positions, normals, uvs, indices, face_shape, shape_mat, _ = sb.concat()
    geom = geometry_of(positions, normals, uvs, indices, face_shape, shape_mat,
                       [builders.UberMaterial(diffuse=(0.5,) * 3)])
    tw = np.stack([dyn.translation((ix * 1.2, 0.0, iz * 1.2))
                   for ix in range(nx) for iz in range(nz)])
    return geom, two_level.build_two_level(geom, tw, np.arange(nx * nz, dtype=np.int32))


@pytest.fixture(scope="module")
def grid100():
    """(jax geometry, jax accel, port geometry, port accel, jax rays, port
    rays): 1,024 rays of ``tests/test_two_level.py``'s seed 7, spread over
    the grid."""
    jg, jacc = _grid((jb, jd, jtl), lambda *a: jb.build_scene(*a).geometry)
    tg, tacc = _grid((tbuild, tdyn, ttl),
                     lambda *a: tbuild.build_scene(*a, device="cpu").geometry)
    rng = np.random.RandomState(7)
    o = rng.uniform(-2.5, 2.5, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (o * np.float32([3.0, 1.0, 3.0]) + np.float32([5.0, 0.0, 5.0])).astype(np.float32)
    jr = JRays.make(jnp.asarray(o), jnp.asarray(d))
    tr = Rays.make(torch.from_numpy(o), torch.from_numpy(d))
    return jg, jacc, tg, tacc, jr, tr


def _check_queries(th, to, rh, ro, what):
    """``tests/test_two_level.py``'s criteria: valid flags equal, t within
    rtol 1e-5 / atol 1e-5 where valid, occluded flags equal."""
    valid = np.asarray(rh.valid)
    np.testing.assert_array_equal(np.asarray(th.valid), valid, err_msg=what)
    np.testing.assert_allclose(np.asarray(th.t)[valid], np.asarray(rh.t)[valid], **LOOP_T_TOL,
                               err_msg=what)
    np.testing.assert_array_equal(np.asarray(to), np.asarray(ro), err_msg=what)
    assert valid.sum() > 50 and np.asarray(ro).sum() > 50, what


def test_loop_oracle_matches_jax_loop(grid100):
    """The port's per-instance loop against the JAX package's on the
    100-instance grid; shape ids equal where valid."""
    jg, jacc, tg, tacc, jr, tr = grid100
    assert tacc.num_instances == 100
    th = ttl.intersect_two_level_loop(tg, tacc, tr)
    jh = jtl.intersect_two_level_loop(jg, jacc, jr)
    _check_queries(th, ttl.occluded_two_level_loop(tg, tacc, tr), jh,
                   jtl.occluded_two_level_loop(jg, jacc, jr), "port loop against jax loop")
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.shape.numpy()[valid], np.asarray(jh.shape)[valid])


def test_loop_oracle_matches_pair_walks(grid100):
    """The port's loop (flat queries, K1-K3's plain versions here) against
    the port's pair walks (K6/K7's plain versions), as
    ``tests/test_two_level.py`` holds the JAX kernels."""
    _, _, tg, tacc, _, tr = grid100
    _check_queries(ttl.intersect_two_level(tg, tacc, tr), ttl.occluded_two_level(tg, tacc, tr),
                   ttl.intersect_two_level_loop(tg, tacc, tr),
                   ttl.occluded_two_level_loop(tg, tacc, tr), "pair walk against loop")


# --------------------------------------------------------------------------
# Parameters taken as the JAX package takes them
# --------------------------------------------------------------------------


def test_scene_from_obj_extra_lights_and_transform_equal_jax():
    """``scene_from_obj(path, extra_lights, transform, camera_kw)`` in the
    JAX package's positional order: the moved mesh and the lights after its
    ``Ke`` emitter equal the JAX scene's."""
    extra = [{"type": LIGHT_POINT, "position": (0.2, 1.5, 0.3), "intensity": (4.0, 3.0, 2.0)},
             {"type": LIGHT_DIRECTIONAL, "direction": (-0.3, -1.0, 0.2),
              "intensity": (1.0, 1.0, 0.9)}]
    m = (tdyn.translation((0.3, -0.2, 0.5)) @ tdyn.rotation_y(0.6)
         @ tdyn.scale((1.2, 0.8, 1.0)))
    camera_kw = dict(eye=(0.0, 1.0, 3.0), target=(0.0, 0.8, 0.0), fov_deg=50.0)
    own, cam = tbuild.scene_from_obj(TEXBOX, extra, m, camera_kw, device="cpu")
    jscene, jcam = jb.scene_from_obj(TEXBOX, extra, m, camera_kw)
    assert_records_equal(own, port_scene(jscene))
    assert_cameras_close(cam, jcam)
    assert own.lights.num == 3 and own.lights.type.tolist()[1:] == [LIGHT_POINT,
                                                                     LIGHT_DIRECTIONAL]
    plain, _ = tbuild.scene_from_obj(TEXBOX, device="cpu")
    assert not torch.equal(plain.geometry.positions, own.geometry.positions)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_set_transform_on_top_of_transforms_equals_jax(as_tensor):
    """``SceneAnimator.set_transform(shape, m, transforms)`` sets one
    shape's matrix over the given ones, as the JAX package's does: a
    chained edit keeps the first shape moved."""
    jscene = jb.cornell_box()[0]
    anim = tdyn.SceneAnimator.create(port_scene(jscene))
    janim = jd.SceneAnimator.create(jscene)
    first = anim.identity_transforms()
    first[5] = tdyn.translation((0.2, 0.0, -0.1))
    m = tdyn.translation((-0.1, 0.05, 0.2)) @ tdyn.rotation_y(0.5)
    given = torch.from_numpy(first) if as_tensor else first
    out = anim.set_transform(6, m, transforms=given)
    jout = janim.set_transform(6, m, transforms=first)
    for jv, tv in ((jout.geometry.positions, out.geometry.positions),
                   (jout.geometry.normals, out.geometry.normals),
                   (jout.shapes.to_world, out.shapes.to_world),
                   (jout.lights.tri_cdf, out.lights.tri_cdf)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert np.array_equal(first[6], np.eye(4, dtype=np.float32))  # the given array untouched
    alone = anim.set_transform(6, m)
    assert not torch.equal(alone.geometry.positions, out.geometry.positions)


def test_make_animated_frame_reuses_base_accel_as_jax(monkeypatch):
    """``make_animated_frame(..., base_accel=)`` runs no host build and
    renders the frame the JAX package's ``make_animated_frame`` renders
    from its own base accel (16x16, 1 spp, depth 2, Sobol; ``MIN_AGREE``)."""
    jscene, jcam = jb.glass_gallery()
    scene, cam = port_scene(jscene), _camera(jcam)
    t = np.broadcast_to(np.eye(4, dtype=np.float32), (jscene.shapes.material.shape[0], 4, 4))
    t = t.copy()
    t[1] = tdyn.translation((0.3, 0.1, -0.2)) @ tdyn.rotation_y(0.5)
    base = tb.build_blocked(scene.geometry)

    def boom(*a, **k):
        raise AssertionError("a host build ran although base_accel was given")

    monkeypatch.setattr(tb, "build_blocked", boom)
    cfg = RenderConfig(width=16, height=16, spp=1, sampler=SamplerConfig(type=SamplerType.SOBOL),
                       integrator=IntegratorConfig(max_depth=2))
    frame_fn = tdyn.make_animated_frame(tdyn.SceneAnimator.create(scene), cam, cfg,
                                        base_accel=base)
    _, accum = frame_fn(t, Accumulator.zeros(16, 16, "cpu"), 0)
    jcfg = mcrt_tpu.RenderConfig(width=16, height=16, spp=1,
                                 sampler=JSamplerConfig(type=JSamplerType.SOBOL),
                                 integrator=JIntegratorConfig(max_depth=2))
    jfn = jd.make_animated_frame(jd.SceneAnimator.create(jscene), jcam, jcfg,
                                 base_accel=jpb.build_blocked(jscene.geometry))
    _, jaccum = jfn(jnp.asarray(t), JAccumulator.zeros(16, 16), jnp.asarray(0, jnp.int32))
    img, jimg = accum.image.numpy(), np.asarray(jaccum.image)
    assert _agreement(img, jimg) >= MIN_AGREE and img.mean() > 0.0


@pytest.fixture
def sort_calls(monkeypatch):
    """Counts the port's coherence sorts."""
    calls = []
    original = tb._coherence_order

    def counting(*a, **k):
        calls.append(1)
        return original(*a, **k)

    monkeypatch.setattr(tb, "_coherence_order", counting)
    return calls


@pytest.mark.parametrize("sort", [None, False, True])
@pytest.mark.parametrize("name", ["cornell_box", "glass_gallery"])
def test_blocked_intersector_sort_equals_jax(name, sort, sort_calls):
    """``blocked_intersector(acc, sort)``: the queries sort their rays only
    where asked (by default from ``SORT_MIN_BLOCKS`` blocks on, so on
    ``glass_gallery`` and not on the one-block ``cornell_box``) and answer
    as the JAX package's intersector under the same ``sort``."""
    jscene = getattr(jb, name)()[0]
    scene = port_scene(jscene)
    jr, tr = both_rays(random_ray_arrays(jscene, 600, seed=2))
    tacc = tb.build_blocked(scene.geometry)
    isect = taccel.blocked_intersector(tacc, sort=sort)
    th, to = isect.intersect(scene, tr), isect.occluded(scene, tr)
    jsect = jaccel.blocked_intersector(jpb.build_blocked(jscene.geometry), sort=sort)
    _check_queries(th, to, jsect.intersect(jscene, jr), jsect.occluded(jscene, jr),
                   f"{name} sort={sort}")
    expect = tacc.num_blocks >= taccel.SORT_MIN_BLOCKS if sort is None else sort
    assert len(sort_calls) == (2 if expect else 0)


@pytest.mark.parametrize("sort", [False, True])
def test_two_level_sort_equals_jax(sort, sort_calls):
    """``intersect_two_level`` / ``occluded_two_level(..., sort)`` on
    ``instanced_boxes``: with ``sort=False`` the walks take the rays in
    their given order, and both answer as the JAX package's queries under
    the same ``sort``."""
    jscene = jb.instanced_boxes(3)[0]
    scene = port_scene(jscene)
    jacc = jtl.build_two_level_scene(jscene.geometry, jscene.shapes.to_world, jscene.instances)
    tacc = ttl.build_two_level_scene(scene.geometry, scene.shapes.to_world, scene.instances)
    jr, tr = both_rays(random_ray_arrays(jscene, 600, seed=4))
    th = ttl.intersect_two_level(scene.geometry, tacc, tr, sort=sort)
    to = ttl.occluded_two_level(scene.geometry, tacc, tr, sort=sort)
    _check_queries(th, to, jtl.intersect_two_level(jscene.geometry, jacc, jr, sort=sort),
                   jtl.occluded_two_level(jscene.geometry, jacc, jr, sort=sort), f"sort={sort}")
    assert len(sort_calls) == (2 if sort else 0)
    sorted_hits = ttl.intersect_two_level(scene.geometry, tacc, tr)
    assert torch.equal(sorted_hits.valid, th.valid) and torch.equal(sorted_hits.t, th.t)
