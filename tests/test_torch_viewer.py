"""The port's progressive viewer (``mcrt_tpu_torch/viewer.py``) on the CPU:
the 8 cases of ``tests/test_viewer.py`` at 16x16, and the port held
against the JAX ``ProgressiveViewer`` under the same edit sequence.

- The ported cases: the HTTP endpoints and progression, the camera orbit,
  the material and light edits without an accel rebuild, the stats
  endpoint, the scene switch, the transform of a baked shape, and picking
  (over HTTP, answered by the render loop, as the HTTP threads never touch
  a tensor).
- Against the JAX viewer (``cornell_box`` 16x16, depth 2, the default
  RANDOM sampler, whose streams are bit-equal; the JAX side on its
  brute-force oracle): after each edit (orbit, material, light, baked
  transform, the instanced transform on ``instanced_boxes``, the switch to
  ``textured_hall``) both step the same frames; the orbit's eye within
  1e-6, ``status`` equal, and the displayed images agree on at least
  ``MIN_AGREE`` of pixels at rtol 1e-3 / atol 1e-4.
- ``Renderer.update_scene(rebuild_accel=False)`` keeps the intersector and
  resets the accumulation; the default refits or rebuilds.
"""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mcrt_tpu_torch import Renderer, RenderConfig
from mcrt_tpu_torch.config import IntegratorConfig
from mcrt_tpu_torch.scene import builders
from mcrt_tpu_torch.utils.image import read_png
from mcrt_tpu_torch.viewer import ProgressiveViewer

torch.set_num_threads(1)

SIZE = 16
MIN_AGREE = 0.99
STEPS = 2  # frames both viewers step after each edit


def _cfg():
    return RenderConfig(width=SIZE, height=SIZE, spp=64, samples_per_pass=1,
                        integrator=IntegratorConfig(max_depth=2))


def _viewer(name="cornell_box"):
    scene, camera = getattr(builders, name)(device="cpu")
    return ProgressiveViewer(Renderer(scene, camera, _cfg(), device="cpu"), port=0,
                             scene_name=name)


@pytest.fixture()
def viewer():
    v = _viewer()
    yield v
    v.stop()


def _get(v, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}", timeout=60) as resp:
        return resp.status, resp.read()


def _serve(v, max_steps):
    t = threading.Thread(target=v.serve, kwargs={"max_steps": max_steps}, daemon=True)
    t.start()
    t.join(timeout=180)
    assert not t.is_alive()


def _png(v, tmp_path):
    path = tmp_path / "view.png"
    path.write_bytes(v.png_bytes())
    return read_png(str(path))


# --------------------------------------------------------------------------
# tests/test_viewer.py's cases
# --------------------------------------------------------------------------


def test_endpoints_and_progression(viewer, tmp_path):
    _serve(viewer, 3)
    code, page = _get(viewer, "/")
    assert code == 200 and b"mcrt_tpu_torch" in page
    code, png = _get(viewer, "/image.png")
    assert code == 200 and png[:4] == b"\x89PNG"
    (tmp_path / "served.png").write_bytes(png)
    img = read_png(str(tmp_path / "served.png"))
    assert img.shape == (SIZE, SIZE, 3) and img.mean() > 0.05
    code, st = _get(viewer, "/api/status")
    status = json.loads(st)
    assert status["spp"] == 3 and status["width"] == SIZE


def test_camera_edit_resets_and_changes_view(viewer, tmp_path):
    viewer.renderer.step(2)
    before = _png(viewer, tmp_path)
    pos_before = viewer.renderer.camera.position.clone()
    viewer.enqueue_orbit(yaw=0.6)
    viewer._apply_edits()
    assert viewer.renderer.accum.frame == 0
    assert not torch.allclose(viewer.renderer.camera.position, pos_before)
    viewer.renderer.step(2)
    assert not np.array_equal(before, _png(viewer, tmp_path))


def test_material_edit_applies_without_accel_rebuild(viewer):
    viewer.renderer.step(1)
    isect_before = viewer.renderer.intersector
    diffuse_before = viewer.renderer.scene.materials.diffuse
    viewer.enqueue_material(0, diffuse=(0.9, 0.1, 0.1), roughness=0.5)
    viewer._apply_edits()
    assert viewer.renderer.accum.frame == 0
    assert viewer.renderer.intersector is isect_before  # no rebuild, no refit
    mats = viewer.renderer.scene.materials
    np.testing.assert_allclose(mats.diffuse[0].numpy(), (0.9, 0.1, 0.1))
    np.testing.assert_allclose(float(mats.roughness[0]), 0.5)
    assert not torch.equal(diffuse_before[0], mats.diffuse[0])  # edited out of place


def test_light_edit_applies_and_resets(viewer):
    viewer.renderer.step(2)
    mean_before = float(viewer.renderer.display_image().mean())
    isect_before = viewer.renderer.intersector
    viewer.enqueue_light(0, intensity=(90.0, 80.0, 70.0), position=(0.1, 1.9, 0.2))
    viewer._apply_edits()
    assert viewer.renderer.accum.frame == 0
    assert viewer.renderer.intersector is isect_before
    lights = viewer.renderer.scene.lights
    np.testing.assert_allclose(lights.intensity[0].numpy(), (90.0, 80.0, 70.0))
    np.testing.assert_allclose(lights.position[0].numpy(), (0.1, 1.9, 0.2))
    viewer.renderer.step(2)  # a brighter light: a brighter image
    assert float(viewer.renderer.display_image().mean()) > mean_before


def test_stats_endpoint(viewer):
    _serve(viewer, 2)
    code, body = _get(viewer, "/api/stats")
    st = json.loads(body)
    assert code == 200
    assert st["spp"] == 2 and st["scene"] == "cornell_box"
    assert st["render_time_s"] > 0.0 and st["samples_per_sec"] > 0.0
    assert st["scene_bytes"] > 0 and st["accel_bytes"] > 0
    assert st["device_bytes_in_use"] == 0 and st["device_bytes_limit"] == 0  # the CPU


@pytest.mark.parametrize("accel", ["BRUTE", "LBVH"])
def test_stats_under_brute_and_lbvh(accel):
    """The stats endpoint under the accels with no tables (``BRUTE``: its
    accel is None, 0 bytes) and with the LBVH's tables (their bytes)."""
    from mcrt_tpu_torch.config import AccelType
    from mcrt_tpu_torch.runtime.platform import nbytes

    scene, camera = builders.cornell_box(device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=64, samples_per_pass=1,
                       accel=AccelType[accel], integrator=IntegratorConfig(max_depth=2))
    v = ProgressiveViewer(Renderer(scene, camera, cfg, device="cpu"), port=0)
    try:
        _serve(v, 2)
        code, body = _get(v, "/api/stats")
        st = json.loads(body)
        accel_obj = v.renderer.intersector.accel
        assert code == 200 and st["spp"] == 2 and st["samples_per_sec"] > 0.0
        assert st["accel_bytes"] == nbytes(accel_obj)
        if accel == "BRUTE":
            assert accel_obj is None and st["accel_bytes"] == 0
        else:
            assert st["accel_bytes"] >= accel_obj.unified.numel() * 4 > 0
    finally:
        v.stop()


def test_scene_switcher(viewer):
    code, body = _get(viewer, "/api/scenes")
    assert code == 200 and "cornell_box" in json.loads(body)["scenes"]
    old_renderer = viewer.renderer
    _get(viewer, "/api/scene?name=textured_hall")
    viewer._apply_edits()
    assert viewer.renderer is not old_renderer
    assert viewer._scene_name == "textured_hall"
    assert viewer.renderer.device == old_renderer.device
    viewer.renderer.step(1)
    assert viewer.renderer.accum.frame == 1
    with pytest.raises(urllib.error.HTTPError):  # unknown scenes are refused
        _get(viewer, "/api/scene?name=does_not_exist")
    with pytest.raises(urllib.error.HTTPError, match="400"):  # so are values not numbers
        _get(viewer, "/api/camera?yaw=left")
    assert not viewer._edits


def test_transform_edit_moves_entity(viewer):
    viewer.enqueue_material(0, diffuse=(0.9, 0.1, 0.1))
    viewer._apply_edits()
    p_before = viewer.renderer.scene.geometry.positions.clone()
    slot_prim = viewer.renderer.intersector.accel.slot_prim
    viewer.enqueue_transform(5, translate=(0.3, 0.0, 0.0))  # the tall box
    viewer._apply_edits()
    assert viewer.renderer.accum.frame == 0
    p_after = viewer.renderer.scene.geometry.positions
    assert float((p_after - p_before).abs().max()) > 0.25  # it moved
    assert viewer.renderer.intersector.accel.slot_prim is slot_prim  # refitted
    np.testing.assert_allclose(viewer.renderer.scene.materials.diffuse[0].numpy(),
                               (0.9, 0.1, 0.1))  # the material edit carried over
    viewer.renderer.step(1)


def test_pick_entity(viewer):
    sel = viewer.pick(0.5, 0.4)
    assert sel["hit"] is True
    assert 0 <= sel["shape"] <= 7 and sel["material"] >= 0 and sel["t"] > 0
    assert sel["instanced"] is False
    # over HTTP the render loop answers
    t = threading.Thread(target=viewer.serve, daemon=True)
    t.start()
    try:
        code, body = _get(viewer, "/api/pick?u=0.5&v=0.4")
    finally:
        viewer.stop()
        t.join(timeout=60)
    assert not t.is_alive()
    assert code == 200 and json.loads(body) == sel


def test_pick_instance_on_instanced_boxes():
    v = _viewer("instanced_boxes")
    try:
        hits = [v.pick(u, 0.3) for u in np.linspace(0.2, 0.8, 13)]
    finally:
        v.stop()
    assert any(h["hit"] and h["instanced"] for h in hits)


# --------------------------------------------------------------------------
# Renderer.update_scene(rebuild_accel=)
# --------------------------------------------------------------------------


def test_update_scene_without_rebuild_keeps_the_intersector():
    scene, camera = builders.cornell_box(device="cpu")
    r = Renderer(scene, camera, _cfg(), device="cpu")
    r.step(2)
    isect = r.intersector
    edited = r.scene.replace(materials=r.scene.materials.replace(
        diffuse=r.scene.materials.diffuse * 0.5))
    r.update_scene(edited, rebuild_accel=False)
    assert r.intersector is isect
    assert r.scene.materials.diffuse is edited.materials.diffuse
    assert r.accum.frame == 0 and float(r.accum.weight.abs().sum()) == 0.0
    r.update_scene(edited)  # the default refits: same faces
    assert r.intersector is not isect
    assert r.intersector.accel.slot_prim is isect.accel.slot_prim


# --------------------------------------------------------------------------
# Against the JAX viewer
# --------------------------------------------------------------------------


def _jax_viewer(name):
    from mcrt_tpu import RenderConfig as JRenderConfig
    from mcrt_tpu import Renderer as JRenderer
    from mcrt_tpu.config import AccelType
    from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
    from mcrt_tpu.scene import builders as jb
    from mcrt_tpu.viewer import ProgressiveViewer as JViewer

    cfg = JRenderConfig(width=SIZE, height=SIZE, spp=64, samples_per_pass=1,
                        accel=AccelType.AUTO if name == "instanced_boxes" else AccelType.BRUTE,
                        integrator=JIntegratorConfig(max_depth=2))
    return JViewer(JRenderer(*getattr(jb, name)(), cfg), port=0, scene_name=name)


EDITS = {  # scene: the edit sequence, each (enqueue method, args, kwargs)
    "cornell_box": [
        ("enqueue_orbit", (), {"yaw": 0.6, "pitch": 0.1}),
        ("enqueue_orbit", (), {"dolly": 0.9}),
        ("enqueue_material", (1,), {"diffuse": (0.2, 0.7, 0.3), "roughness": 0.5}),
        ("enqueue_light", (0,), {"intensity": (30.0, 20.0, 10.0)}),
        ("enqueue_transform", (5,), {"translate": (0.2, 0.0, 0.1), "rotate_y": 0.3}),
        ("enqueue_scene", ("textured_hall",), {}),
    ],
    "instanced_boxes": [
        ("enqueue_transform", (1,), {"translate": (0.1, 0.0, -0.1), "scale": 1.1}),
        ("enqueue_material", (0,), {"diffuse": (0.5, 0.5, 0.1)}),
    ],
}


@pytest.mark.parametrize("name", list(EDITS))
def test_edit_sequence_matches_jax_viewer(name):
    jv, tv = _jax_viewer(name), _viewer(name)
    try:
        for i, (method, args, kw) in enumerate(EDITS[name]):
            for v in (jv, tv):
                getattr(v, method)(*args, **kw)
                v._apply_edits()
                assert int(v.renderer.accum.frame) == 0
                v.renderer.step(STEPS)
            np.testing.assert_allclose(tv._eye, np.asarray(jv._eye), rtol=0, atol=1e-6)
            np.testing.assert_allclose(tv.renderer.camera.position.numpy(),
                                       np.asarray(jv.renderer.camera.position),
                                       rtol=0, atol=1e-6)
            assert tv.status() == jv.status()
            a = tv.renderer.display_image().numpy()
            b = np.asarray(jv.renderer.display_image()).reshape(a.shape)
            share = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1).mean()
            print(f"{name} edit {i} ({method}): agreeing pixels {share:.4f}, means "
                  f"{a.mean():.6f} / {b.mean():.6f}")
            assert share >= MIN_AGREE, (method, share)
    finally:
        jv.stop()
        tv.stop()
