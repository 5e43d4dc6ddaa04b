"""Progressive HTTP viewer (counterpart of ``mcrt_tpu/viewer.py``): a live
view of the accumulating image and the interactive edit loops:

- **camera orbit and dolly** around the scene centre -> accumulation reset;
- **material edit** (diffuse, roughness) -> scene swap + reset, the accel
  kept (``Renderer.update_scene(..., rebuild_accel=False)``);
- **light edit** (intensity, position) -> the same;
- **shape transform** (move, rotate about y, scale): an instanced shape
  through ``scene.dynamic.set_shape_transform`` (a two-level refit), a
  baked shape through a ``SceneAnimator`` of the first scene (a blocked
  refit), keeping the material and light edits made since;
- **scene switch** -> a new ``Renderer`` on a built-in scene (``cli.SCENES``:
  the JAX viewer's five and the port's other builders); a scene whose
  asset (``bunny.obj`` under ``$MCRT_ASSETS``) is missing is refused on
  stderr and the current one kept.

It serves a page at ``/`` (the image, refreshed each second, and the
controls), the tonemapped frame at ``/image.png``, ``/api/status`` (spp and
resolution), ``/api/stats`` (spp, render time, samples/s, the accel's and
the scene's bytes and the card's memory), ``/api/pick`` (the shape under a
film point) and the edit endpoints.

The render loop runs in the calling thread (``serve``).  HTTP handlers run
in the server's threads and never touch a tensor: they enqueue edits and
picks, which the loop applies between frames, and they answer from the
host copies (PNG bytes, status, stats) that the loop publishes under a
lock.  The PNG is encoded with ``utils/image.py`` (no imaging library).

Usage: ``python -m mcrt_tpu_torch view --scene cornell_box --port 8000``.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import urllib.parse
from concurrent.futures import Future, TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .cli import SCENES

PNG_INTERVAL_S = 0.5  # least seconds between two PNGs the loop publishes
PICK_TIMEOUT_S = 30.0  # how long a pick request waits for the render loop

_PAGE = """<!doctype html>
<html><head><title>mcrt_tpu_torch viewer</title><style>
body { background:#181818; color:#ddd; font-family:monospace; }
img { image-rendering:pixelated; width:512px; border:1px solid #444; }
button { margin:2px; } input { width: 56px; }
</style></head><body>
<h3>mcrt_tpu_torch progressive viewer</h3>
<div><img id="view" src="/image.png"></div>
<div id="status">-</div>
<div>
 orbit:
 <button onclick="cam(-0.2,0)">&larr;</button>
 <button onclick="cam(0.2,0)">&rarr;</button>
 <button onclick="cam(0,0.15)">&uarr;</button>
 <button onclick="cam(0,-0.15)">&darr;</button>
 dolly:
 <button onclick="dolly(0.9)">+</button>
 <button onclick="dolly(1.1)">-</button>
</div>
<div>
 material <input id="mid" value="0"> diffuse
 <input id="r" value="0.6"> <input id="g" value="0.6"> <input id="b" value="0.6">
 roughness <input id="rough" value="">
 <button onclick="mat()">apply</button>
</div>
<div>
 light <input id="lid" value="0"> intensity
 <input id="lr" value=""> <input id="lg" value=""> <input id="lb" value="">
 position <input id="lx" value=""> <input id="ly" value=""> <input id="lz" value="">
 <button onclick="light()">apply</button>
</div>
<div>
 shape <input id="sid" value="0"> move
 <input id="sx" value="0"> <input id="sy" value="0"> <input id="sz" value="0">
 rotY <input id="sry" value=""> scale <input id="ss" value="">
 <button onclick="xform()">apply</button>
</div>
<div>
 scene <select id="scene"></select>
 <button onclick="loadScene()">load</button>
 <span id="stats"></span>
</div>
<script>
async function tick() {
  const s = await (await fetch('/api/status')).json();
  document.getElementById('status').textContent =
    s.width + 'x' + s.height + '  spp=' + s.spp;
  const st = await (await fetch('/api/stats')).json();
  document.getElementById('stats').textContent =
    ' ' + st.samples_per_sec.toFixed(2) + ' spp/s, ' +
    st.render_time_s.toFixed(1) + 's, accel ' +
    (st.accel_bytes/1e6).toFixed(1) + ' MB, card ' +
    (st.device_bytes_in_use/1e6).toFixed(1) + ' MB';
  document.getElementById('view').src = '/image.png?ts=' + Date.now();
}
setInterval(tick, 1000);
async function scenes() {
  const s = await (await fetch('/api/scenes')).json();
  const sel = document.getElementById('scene');
  for (const n of s.scenes) {
    const o = document.createElement('option');
    o.value = n; o.textContent = n; sel.appendChild(o);
  }
}
scenes();
function cam(yaw, pitch) {
  fetch('/api/camera?yaw=' + yaw + '&pitch=' + pitch);
}
function dolly(f) { fetch('/api/camera?dolly=' + f); }
function mat() {
  const q = new URLSearchParams({
    id: document.getElementById('mid').value,
    r: document.getElementById('r').value,
    g: document.getElementById('g').value,
    b: document.getElementById('b').value,
    roughness: document.getElementById('rough').value,
  });
  fetch('/api/material?' + q);
}
function light() {
  const v = id => document.getElementById(id).value;
  const q = new URLSearchParams({id: v('lid'), ir: v('lr'), ig: v('lg'),
    ib: v('lb'), x: v('lx'), y: v('ly'), z: v('lz')});
  fetch('/api/light?' + q);
}
function loadScene() {
  fetch('/api/scene?name=' + document.getElementById('scene').value);
}
function xform() {
  const v = id => document.getElementById(id).value;
  const q = new URLSearchParams({shape: v('sid'), x: v('sx'), y: v('sy'),
    z: v('sz'), ry: v('sry'), s: v('ss')});
  fetch('/api/transform?' + q);
}
</script></body></html>
"""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _set_row(table: torch.Tensor, row: int, value) -> torch.Tensor:
    """``table`` with one row replaced, out of place; a row outside the
    table leaves it as it is (as a JAX scatter drops it)."""
    if not -table.shape[0] <= row < table.shape[0]:
        return table
    idx = torch.tensor([row], device=table.device)
    val = torch.as_tensor(value, dtype=table.dtype).to(table.device)
    return table.index_put((idx,), val.reshape((1,) + table.shape[1:]))


class ProgressiveViewer:
    """Owns a ``Renderer`` and serves its accumulator over HTTP while the
    caller's thread steps it progressively (``serve``)."""

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8000,
                 scene_name: str = "custom"):
        self.renderer = renderer
        self._edits: list = []
        self._picks: list = []
        self._lock = threading.Lock()  # the queues and the published copies
        self._stop = threading.Event()
        self._scene_name = scene_name
        self._render_time = 0.0  # wall seconds spent rendering samples
        self._rate = 0.0  # samples/s of the last frame
        self._animator = None  # SceneAnimator of the scene, made at its first baked move
        self._transforms = None
        # orbit state: the pivot at the scene centre, the eye from the camera
        self._pivot = _host(renderer.scene.center).astype(np.float32)
        self._eye = _host(renderer.camera.position).astype(np.float32)
        self._up = (0.0, 1.0, 0.0)
        self._published: dict = {}
        self._png_at = 0.0
        self.publish(png=True)
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                try:
                    viewer._handle(self)
                except ValueError:  # a query value that is not a number
                    viewer._send(self, 400, b'{"error": "bad query"}', "application/json")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_port
        self._http_thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._http_thread.start()

    # ---- HTTP (the server's threads: no tensor is touched here) ---------
    def _handle(self, req: BaseHTTPRequestHandler):
        url = urllib.parse.urlparse(req.path)
        q = dict(urllib.parse.parse_qsl(url.query))
        ok = b"{}"
        if url.path == "/":
            self._send(req, 200, _PAGE.encode(), "text/html")
        elif url.path == "/image.png":
            self._send(req, 200, self._read("png"), "image/png")
        elif url.path in ("/api/status", "/api/stats"):
            body = json.dumps(self._read(url.path[len("/api/"):])).encode()
            self._send(req, 200, body, "application/json")
        elif url.path == "/api/camera":
            self.enqueue_orbit(yaw=float(q.get("yaw", 0.0)), pitch=float(q.get("pitch", 0.0)),
                               dolly=float(q.get("dolly", 1.0)))
            self._send(req, 200, ok, "application/json")
        elif url.path == "/api/material":
            kw = {}
            if all(k in q for k in ("r", "g", "b")):
                kw["diffuse"] = (float(q["r"]), float(q["g"]), float(q["b"]))
            if q.get("roughness"):
                kw["roughness"] = float(q["roughness"])
            self.enqueue_material(int(q.get("id", 0)), **kw)
            self._send(req, 200, ok, "application/json")
        elif url.path == "/api/pick":
            fut = self.enqueue_pick(float(q.get("u", 0.5)), float(q.get("v", 0.5)))
            try:
                sel = fut.result(timeout=PICK_TIMEOUT_S)
            except FutureTimeout:
                self._send(req, 503, b'{"error": "the render loop is not running"}',
                           "application/json")
                return
            self._send(req, 200, json.dumps(sel).encode(), "application/json")
        elif url.path == "/api/transform":
            kw = {}
            if all(q.get(k) for k in ("x", "y", "z")):
                kw["translate"] = (float(q["x"]), float(q["y"]), float(q["z"]))
            if q.get("ry"):
                kw["rotate_y"] = float(q["ry"])
            if q.get("s"):
                kw["scale"] = float(q["s"])
            self.enqueue_transform(int(q.get("shape", 0)), **kw)
            self._send(req, 200, ok, "application/json")
        elif url.path == "/api/light":
            kw = {}
            if all(q.get(k) for k in ("ir", "ig", "ib")):
                kw["intensity"] = (float(q["ir"]), float(q["ig"]), float(q["ib"]))
            if all(q.get(k) for k in ("x", "y", "z")):
                kw["position"] = (float(q["x"]), float(q["y"]), float(q["z"]))
            self.enqueue_light(int(q.get("id", 0)), **kw)
            self._send(req, 200, ok, "application/json")
        elif url.path == "/api/scenes":
            self._send(req, 200, json.dumps({"scenes": list(SCENES)}).encode(),
                       "application/json")
        elif url.path == "/api/scene":
            name = q.get("name", "")
            if name not in SCENES:
                self._send(req, 400, b'{"error": "unknown scene"}', "application/json")
            else:
                self.enqueue_scene(name)
                self._send(req, 200, ok, "application/json")
        else:
            self._send(req, 404, b"not found", "text/plain")

    @staticmethod
    def _send(req, code, body: bytes, ctype: str):
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.send_header("Cache-Control", "no-store")
        req.end_headers()
        req.wfile.write(body)

    def _read(self, key: str):
        with self._lock:
            return self._published[key]

    # ---- state (the render loop's thread) --------------------------------
    def png_bytes(self) -> bytes:
        """The displayed image (denoise and tone map where the config
        enables them), sRGB, top row first, as PNG bytes."""
        from .utils.image import encode_png, to_srgb_u8

        return encode_png(to_srgb_u8(self.renderer.display_image(), flip_vertical=True))

    def status(self) -> dict:
        r = self.renderer
        return {"spp": int(r.accum.frame), "width": r.cfg.width, "height": r.cfg.height}

    def stats(self) -> dict:
        """spp, wall render time, progressive throughput, the accel's and
        the scene's bytes, and the renderer's card memory (0 on the CPU)."""
        from .runtime.platform import device_memory_stats, nbytes

        r = self.renderer
        dev = device_memory_stats(r.device)
        return {
            "spp": int(r.accum.frame),
            "scene": self._scene_name,
            "render_time_s": round(self._render_time, 3),
            "samples_per_sec": round(self._rate, 4),
            "accel_bytes": nbytes(r.intersector.accel),
            "scene_bytes": nbytes(r.scene),
            "device_bytes_in_use": int(dev.get("bytes_in_use", 0)),
            "device_bytes_limit": int(dev.get("bytes_limit", 0)),
        }

    def publish(self, png: bool = False):
        """Copy status and stats, and with ``png`` the PNG, to the host
        copies the HTTP handlers answer from."""
        out = {"status": self.status(), "stats": self.stats()}
        if png:
            out["png"] = self.png_bytes()
            self._png_at = time.monotonic()
        with self._lock:
            self._published.update(out)

    def pick(self, u: float, v: float) -> dict:
        """The camera ray through film (u, v), a one-ray wavefront through
        the renderer's intersector: the shape it hits, its primitive,
        distance, material and light, and whether it is an instance."""
        from .core.types import Rays

        r = self.renderer
        uv = torch.tensor([[u, v]], dtype=torch.float32, device=r.device)
        o, d = r.camera.generate_rays(uv)
        hit = r.intersector.intersect(r.scene, Rays.make(o, d))
        if not bool(hit.valid[0]):
            return {"hit": False}
        shape = int(hit.shape[0])
        scene = r.scene
        return {
            "hit": True,
            "shape": shape,
            "prim": int(hit.prim[0]),
            "t": float(hit.t[0]),
            "material": int(scene.shapes.material[shape]),
            "light": int(scene.shapes.light[shape]),
            "instanced": bool(scene.instances is not None
                              and shape in scene.instances.shape.tolist()),
        }

    # ---- edits (enqueued by HTTP threads, applied by the render loop) ----
    def _enqueue(self, kind, payload):
        with self._lock:
            self._edits.append((kind, payload))

    def enqueue_orbit(self, yaw=0.0, pitch=0.0, dolly=1.0):
        self._enqueue("camera", (yaw, pitch, dolly))

    def enqueue_material(self, mat_id: int, **kw):
        self._enqueue("material", (mat_id, kw))

    def enqueue_light(self, light_id: int, **kw):
        self._enqueue("light", (light_id, kw))

    def enqueue_transform(self, shape_id: int, **kw):
        self._enqueue("transform", (shape_id, kw))

    def enqueue_scene(self, name: str):
        self._enqueue("scene", name)

    def enqueue_pick(self, u: float, v: float) -> Future:
        """A pick for the render loop to answer; the future holds its
        ``pick`` result."""
        fut: Future = Future()
        with self._lock:
            self._picks.append((u, v, fut))
        return fut

    def _answer_picks(self):
        with self._lock:
            picks, self._picks = self._picks, []
        for u, v, fut in picks:
            try:
                fut.set_result(self.pick(u, v))
            except Exception as e:  # the HTTP thread reports it; the loop goes on
                fut.set_exception(e)

    def _orbit(self, yaw, pitch, dolly):
        from .camera.pinhole import PinholeCamera

        v = self._eye - self._pivot
        cy, sy = np.cos(yaw), np.sin(yaw)
        v = np.asarray([cy * v[0] + sy * v[2], v[1], -sy * v[0] + cy * v[2]], np.float32)
        r_xz = float(np.linalg.norm([v[0], v[2]]))
        ang = float(np.clip(float(np.arctan2(v[1], r_xz)) + pitch, -1.45, 1.45))
        rad = float(np.linalg.norm(v)) * dolly
        v = np.asarray([v[0] / max(r_xz, 1e-6) * np.cos(ang), np.sin(ang),
                        v[2] / max(r_xz, 1e-6) * np.cos(ang)], np.float32) * rad
        self._eye = self._pivot + v
        cam = self.renderer.camera
        self.renderer.update_camera(PinholeCamera.look_at(
            eye=self._eye, target=self._pivot, up=self._up,
            fov_deg=float(np.rad2deg(2.0 * np.arctan(float(cam.tan_half_fov)))),
            aspect=float(cam.aspect), device=self.renderer.device))

    def _transform(self, shape_id, kw):
        from .scene.dynamic import (SceneAnimator, rotation_y, scale, set_shape_transform,
                                    translation)

        m = translation(kw.get("translate", (0.0, 0.0, 0.0)))
        if "rotate_y" in kw:
            m = m @ rotation_y(kw["rotate_y"])
        if "scale" in kw:
            m = m @ scale(kw["scale"])
        scene = self.renderer.scene
        inst_shapes = (set(scene.instances.shape.tolist()) if scene.instances is not None
                       else set())
        if shape_id in inst_shapes:
            # an instance: a transform-only edit, which update_scene refits
            self.renderer.update_scene(set_shape_transform(scene, shape_id, m))
            return
        # a baked shape: its vertices re-transformed from the first scene,
        # with the material and light edits made since carried over
        if self._animator is None:
            self._animator = SceneAnimator.create(scene)
            self._transforms = self._animator.identity_transforms()
        self._transforms[shape_id] = m
        out = self._animator.transformed(self._transforms)
        out = out.replace(materials=scene.materials, lights=out.lights.replace(
            intensity=scene.lights.intensity, position=scene.lights.position))
        self.renderer.update_scene(out)

    def _switch(self, name):
        from .renderer import Renderer
        from .scene import builders

        device = self.renderer.device
        try:
            scene, camera = getattr(builders, name)(device=device)
        except FileNotFoundError as e:  # a scene whose asset is missing: keep this one
            print(f"viewer: cannot switch to {name}: {e}", file=sys.stderr, flush=True)
            return
        self.renderer = Renderer(scene, camera, self.renderer.cfg, device=device)
        self._scene_name = name
        self._pivot = _host(scene.center).astype(np.float32)
        self._eye = _host(camera.position).astype(np.float32)
        self._render_time = 0.0
        self._animator = None
        self._transforms = None

    def _apply_edits(self) -> bool:
        """Drain and apply the queued edits; returns whether any were."""
        with self._lock:
            edits, self._edits = self._edits, []
        for kind, payload in edits:
            if kind == "camera":
                self._orbit(*payload)
            elif kind == "material":
                mat_id, kw = payload
                scene = self.renderer.scene
                mats = scene.materials
                if "diffuse" in kw:
                    mats = mats.replace(diffuse=_set_row(mats.diffuse, mat_id, kw["diffuse"]))
                if "roughness" in kw:
                    mats = mats.replace(roughness=_set_row(mats.roughness, mat_id,
                                                           kw["roughness"]))
                # the geometry is unchanged: the accel stays
                self.renderer.update_scene(scene.replace(materials=mats), rebuild_accel=False)
            elif kind == "light":
                light_id, kw = payload
                scene = self.renderer.scene
                lights = scene.lights
                if "intensity" in kw:
                    lights = lights.replace(intensity=_set_row(lights.intensity, light_id,
                                                               kw["intensity"]))
                if "position" in kw:
                    lights = lights.replace(position=_set_row(lights.position, light_id,
                                                              kw["position"]))
                # lights take no part in the accel
                self.renderer.update_scene(scene.replace(lights=lights), rebuild_accel=False)
            elif kind == "transform":
                self._transform(*payload)
            elif kind == "scene":
                self._switch(payload)
        return bool(edits)

    # ---- loop --------------------------------------------------------------
    def serve(self, max_steps: int | None = None):
        """Run the render loop in this thread (HTTP is served from the
        thread started at construction) until ``stop`` or until
        ``max_steps`` frames have been rendered: answer picks, apply edits,
        step one frame (waiting for the card, so the time is the frame's),
        publish status and stats, and the PNG every ``PNG_INTERVAL_S``."""
        steps = 0
        while not self._stop.is_set():
            self._answer_picks()
            edited = self._apply_edits()
            if not self.renderer.stopped():
                t0 = time.perf_counter()
                self.renderer.step(1)
                if self.renderer.device.type == "cuda":
                    torch.cuda.synchronize(self.renderer.device)
                dt = time.perf_counter() - t0
                self._render_time += dt
                self._rate = self.renderer.cfg.samples_per_pass / dt if dt > 0 else 0.0
                steps += 1
            elif not edited:
                time.sleep(0.05)  # the target spp is reached: idle, not spin
            self.publish(png=time.monotonic() - self._png_at >= PNG_INTERVAL_S)
            if max_steps is not None and steps >= max_steps:
                break
        self.publish(png=True)
        # the HTTP server keeps serving the final image until stop()

    def stop(self):
        """End ``serve`` and the HTTP server, and close its socket."""
        self._stop.set()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self._http_thread.join(timeout=10)
            self.server = None
