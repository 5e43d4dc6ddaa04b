"""The render entry point against the JAX package: the tone map and the
denoiser (``film/``), ``Renderer.display_image``, the PNG output
(``utils/image.py``, written without an imaging library), the device
runtime (``runtime/platform.py`` and its re-exports in ``runtime/``) and
the command line (``cli.py``).

Tolerances: the tone map and denoiser are elementwise float32 formulas
and a fixed stencil, held to rtol 1e-5 / atol 1e-6 of the JAX functions
on seeded HDR images; ``to_srgb_u8`` is bit-equal.  Rendered images take
the renderer's share criterion (0.99 of pixels within rtol 1e-3 / atol
1e-4; for 8-bit PNGs, within 1 level): under RANDOM both packages draw
the same samples, and a pixel differs only where a float32 last bit flips
a decision.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcrt_tpu
from mcrt_tpu import cli as jcli
from mcrt_tpu.config import AccelType as JAccelType
from mcrt_tpu.config import DenoiseConfig as JDenoiseConfig
from mcrt_tpu.config import IntegratorConfig as JIntegratorConfig
from mcrt_tpu.config import ToneMapConfig as JToneMapConfig
from mcrt_tpu.film import denoise as jdenoise
from mcrt_tpu.film import tonemap as jtonemap
from mcrt_tpu.scene import builders as jb
from mcrt_tpu.utils import image as jimage
from chip_smoke import write_standin_obj
from mcrt_tpu_torch import Renderer, RenderConfig, cli
from mcrt_tpu_torch.config import DenoiseConfig, IntegratorConfig, ToneMapConfig
from mcrt_tpu_torch.film import denoise, tonemap
from mcrt_tpu_torch.runtime import platform
from mcrt_tpu_torch.scene.textures import decode_png
from mcrt_tpu_torch.utils import image
from tests.test_torch_parallel import jax_leaves, port_of

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SPP, DEPTH = 32, 4, 3
MIN_AGREE = 0.99


def _hdr(seed, shape=(24, 20, 3)):
    """Seeded HDR image: most values in [0, 1], some far above 1, a few 0."""
    rng = np.random.default_rng(seed)
    img = rng.exponential(0.6, shape).astype(np.float32)
    img[rng.random(shape[:2]) < 0.05] = 0.0
    img[rng.random(shape[:2]) < 0.05] *= 40.0
    return img


@pytest.mark.parametrize("l_white", [1.0, 4.0, 100.0])
def test_reinhard_matches_jax(l_white):
    img = _hdr(1)
    ref = jtonemap.reinhard(jnp.asarray(img), JToneMapConfig(enabled=True, l_white=l_white))
    out = tonemap.reinhard(torch.from_numpy(img), ToneMapConfig(enabled=True, l_white=l_white))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_log_average_luminance_matches_jax():
    img = _hdr(2)
    ref = jtonemap.log_average_luminance(jnp.asarray(img))
    out = tonemap.log_average_luminance(torch.from_numpy(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("radius, sigma_s, sigma_r", [(1, 1.0, 0.1), (3, 2.0, 0.25)])
def test_bilateral_matches_jax(radius, sigma_s, sigma_r):
    img = _hdr(3)
    kw = dict(enabled=True, radius=radius, sigma_spatial=sigma_s, sigma_range=sigma_r)
    ref = jdenoise.bilateral(jnp.asarray(img), JDenoiseConfig(**kw))
    out = denoise.bilateral(torch.from_numpy(img), DenoiseConfig(**kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_display_image_matches_jax_renderer():
    """Denoise and tone map both on: the port's ``Renderer`` against the JAX
    one on ``cornell_box`` (RANDOM, the same samples)."""
    jscene, jcam = jb.cornell_box()
    kw = dict(width=SIZE, height=SIZE, spp=SPP)
    jcfg = mcrt_tpu.RenderConfig(**kw, accel=JAccelType.BRUTE,
                                 integrator=JIntegratorConfig(max_depth=DEPTH),
                                 denoise=JDenoiseConfig(enabled=True),
                                 tonemap=JToneMapConfig(enabled=True))
    jimg = np.asarray(mcrt_tpu.Renderer(jscene, jcam, jcfg).render())
    scene, cam = port_of(jax_leaves(jscene, jcam))
    cfg = RenderConfig(**kw, integrator=IntegratorConfig(max_depth=DEPTH),
                       denoise=DenoiseConfig(enabled=True), tonemap=ToneMapConfig(enabled=True))
    r = Renderer(scene, cam, cfg, device="cpu")
    img = r.render().numpy()
    share = np.isclose(img, jimg, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert share >= MIN_AGREE, share
    raw = r.accum.image
    np.testing.assert_array_equal(
        img, tonemap.reinhard(denoise.bilateral(raw, cfg.denoise), cfg.tonemap).numpy())
    assert img.max() < 0.5 * float(raw.max())  # the tone map compressed the emitter


def test_to_srgb_u8_bit_equal_jax():
    img = _hdr(4)
    img[0, 0] = -1.0
    for flip in (True, False):
        np.testing.assert_array_equal(image.to_srgb_u8(img, flip),
                                      jimage.to_srgb_u8(img, flip))
    np.testing.assert_array_equal(image.to_srgb_u8(torch.from_numpy(img)),
                                  jimage.to_srgb_u8(img))


def test_write_png_reads_back(tmp_path):
    from PIL import Image

    img = _hdr(5, (17, 23, 3))
    path = str(tmp_path / "x.png")
    image.write_png(path, torch.from_numpy(img))
    want = image.to_srgb_u8(img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read())[..., :3], want)
    back = image.read_png(path)
    np.testing.assert_array_equal(back, jimage.read_png(path))
    assert back.shape == (17, 23, 3)


def test_mse_metrics_match_jax():
    a, b = _hdr(6), _hdr(7)
    assert np.isclose(image.mse(a, torch.from_numpy(b)), jimage.mse(a, b), rtol=1e-6)
    assert np.isclose(image.relative_mse(a, b), jimage.relative_mse(a, b), rtol=1e-6)


def test_platform_devices_and_buffers():
    devs = platform.enumerate_devices()
    assert devs and devs[0].index == 0
    if not torch.cuda.is_available():
        assert devs[0].platform == "cpu" and platform.device_memory_stats(0) == {}
    scene, _ = port_of(jax_leaves(*jb.cornell_box()))
    bm = platform.BufferManager()
    size = bm.register("scene", scene)
    assert size == platform.nbytes(scene) > scene.geometry.positions.numel() * 4
    bm.register("extra", {"a": torch.zeros(256), "b": [torch.zeros(4, dtype=torch.int64)]})
    assert bm.total == size + 1024 + 32 and bm.max_total == bm.total
    bm.release("extra")
    assert bm.total == size and bm.max_total == size + 1056
    assert "TOTAL" in bm.report()


@pytest.mark.parametrize("name", ["BufferManager", "DeviceInfo", "buffers",
                                  "device_memory_stats", "enumerate_devices"])
def test_runtime_package_reexports_platform(name):
    """``mcrt_tpu_torch.runtime`` re-exports the platform's names, as
    ``mcrt_tpu.runtime`` does; the process-wide ``buffers`` counts there."""
    import mcrt_tpu_torch.runtime as runtime

    assert getattr(runtime, name) is getattr(platform, name)
    if name == "buffers":
        t = torch.zeros(300, dtype=torch.float32)
        before = runtime.buffers.total
        assert runtime.buffers.register("_reexport_case", {"t": t}) == 1200
        assert platform.buffers.total == before + 1200
        runtime.buffers.release("_reexport_case")
        assert platform.buffers.total == before


def _cli_args(out, *extra):
    return ["render", "--scene", "cornell_box", "--width", str(SIZE), "--height", str(SIZE),
            "--spp", str(SPP), "--max-depth", str(DEPTH), "--out", str(out), *extra]


def test_cli_render_matches_jax_cli(tmp_path, capsys):
    """``main(["render", ...])`` of both packages: the port's PNG (written
    without PIL) within 1 level of the JAX CLI's on 0.99 of pixels."""
    from PIL import Image

    assert cli.main(_cli_args(tmp_path / "port.png", "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "rendered 32x32 @ 4 spp on cpu" in out and "Mrays/s" in out
    assert jcli.main(_cli_args(tmp_path / "jax.png")) == 0
    with open(tmp_path / "port.png", "rb") as f:
        port = decode_png(f.read())[..., :3].astype(np.int64)
    ref = np.asarray(Image.open(tmp_path / "jax.png")).astype(np.int64)
    share = (np.abs(port - ref) <= 1).all(-1).mean()
    assert share >= MIN_AGREE, share
    assert port.mean() > 10


def test_cli_progressive_writes_each_interval(tmp_path, capsys, monkeypatch):
    written = []
    real = image.write_png
    monkeypatch.setattr(image, "write_png",
                        lambda path, img: written.append(path) or real(path, img))
    assert cli.main(_cli_args(tmp_path / "p.png", "--device", "cpu", "--progressive", "2")) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "spp (" in ln]
    assert [ln.split()[0] for ln in lines] == ["2/4", "4/4"]
    assert len(written) == 3  # each interval, then the final image
    assert image.read_png(str(tmp_path / "p.png")).shape == (SIZE, SIZE, 3)


def test_cli_info_prints(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"torch {torch.__version__}") and "device 0:" in out
    assert "native library:" in out


@pytest.mark.parametrize("argv, match", [pytest.param(["bench"], "W1", id="argv1-W1")])
def test_cli_view_and_bench_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv)


def test_cli_renders_heavy_gallery_from_mcrt_assets(tmp_path, monkeypatch, capsys):
    """``render --scene heavy_gallery`` at 16x16 reads ``bunny.obj`` (the
    stand-in mesh here) from ``$MCRT_ASSETS`` and writes a PNG."""
    write_standin_obj(str(tmp_path / "bunny.obj"), subdiv=1)
    monkeypatch.setenv("MCRT_ASSETS", str(tmp_path))
    out = tmp_path / "heavy.png"
    assert cli.main(["render", "--scene", "heavy_gallery", "--device", "cpu", "--width", "16",
                     "--height", "16", "--spp", "1", "--max-depth", "2", "--out", str(out)]) == 0
    assert "rendered 16x16 @ 1 spp on cpu" in capsys.readouterr().out
    img = image.read_png(str(out))
    assert img.shape == (16, 16, 3) and img.mean() > 0


@pytest.mark.parametrize("scene", ["bunny_field", "heavy_gallery", "bunny_field_instanced"])
def test_cli_scene_without_its_asset_exits_nonzero(scene, tmp_path, monkeypatch):
    """Without ``bunny.obj`` the command exits non-zero with the builder's
    message and writes nothing (it never renders another scene); the JAX
    CLI fails with the same message."""
    monkeypatch.setenv("MCRT_ASSETS", str(tmp_path))
    out = tmp_path / "none.png"
    with pytest.raises(SystemExit) as exc:
        cli.main(["render", "--scene", scene, "--device", "cpu", "--width", "8", "--height", "8",
                  "--out", str(out)])
    assert exc.value.code not in (0, None) and "MCRT_ASSETS" in str(exc.value.code)
    assert scene in str(exc.value.code) and not out.exists()
    with pytest.raises(FileNotFoundError, match="MCRT_ASSETS"):
        jcli.main(["render", "--scene", scene, "--out", str(out)])


VIEW_ARGS = ["view", "--device", "cpu", "--port", "0", "--width", "8", "--height", "8",
             "--max-depth", "1"]


def test_cli_view_serves_and_stops_on_interrupt(monkeypatch):
    """``cli.main(["view", ...])`` serves the accumulating image until a
    KeyboardInterrupt, then stops the viewer, closes its socket and returns
    0.  A client thread waits for 2 samples over HTTP, reads the PNG, then
    interrupts the main thread."""
    import _thread
    import threading
    import time
    import urllib.request

    from mcrt_tpu_torch import viewer as viewer_mod

    made, seen, errors = [], {}, []

    class Recorded(viewer_mod.ProgressiveViewer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(viewer_mod, "ProgressiveViewer", Recorded)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{made[0].port}{path}",
                                    timeout=30) as resp:
            return resp.read()

    def client():
        import json

        try:
            deadline = time.monotonic() + 120
            while not made and time.monotonic() < deadline:
                time.sleep(0.05)
            while json.loads(get("/api/status"))["spp"] < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            seen["status"] = json.loads(get("/api/status"))
            seen["png"] = get("/image.png")
        except Exception as e:  # reported below, after the interrupt
            errors.append(e)
        finally:
            _thread.interrupt_main()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    assert cli.main(VIEW_ARGS) == 0
    t.join(timeout=60)
    assert not errors, errors
    assert seen["status"]["spp"] >= 2 and seen["status"]["width"] == 8
    assert seen["png"][:8] == b"\x89PNG\r\n\x1a\n"
    assert made[0].server is None  # stopped, its socket closed


def test_cli_view_subprocess_exits_0_on_sigint(tmp_path):
    """``python -m mcrt_tpu_torch view`` as a subprocess: it prints the
    address it serves, answers ``/image.png``, and exits 0 after SIGINT."""
    import re
    import signal
    import threading
    import urllib.request

    proc = subprocess.Popen([sys.executable, "-m", "mcrt_tpu_torch", *VIEW_ARGS], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    killer = threading.Timer(180, proc.kill)  # a hung server fails the test, not the run
    killer.start()
    try:
        line = proc.stdout.readline()
        port = re.search(r"serving http://127\.0\.0\.1:(\d+)/", line)
        assert port, line + proc.stderr.read()[-2000:]
        with urllib.request.urlopen(f"http://127.0.0.1:{port.group(1)}/image.png",
                                    timeout=60) as resp:
            png = resp.read()
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert proc.returncode == 0, err[-2000:]


def test_cli_config_needs_yaml(tmp_path, monkeypatch):
    """``--config`` reads a YAML RenderConfig; without PyYAML it raises a
    clear error."""
    cfg = tmp_path / "r.yaml"
    cfg.write_text("width: 8\nheight: 6\nspp: 1\nintegrator:\n  max_depth: 1\n")
    out = tmp_path / "c.png"
    assert cli.main(["render", "--config", str(cfg), "--out", str(out), "--device", "cpu"]) == 0
    assert image.read_png(str(out)).shape == (6, 8, 3)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        cli.main(["render", "--config", str(cfg), "--out", str(out), "--device", "cpu"])


def test_main_module_runs_without_jax(tmp_path):
    """``python -m mcrt_tpu_torch`` with jax made unimportable."""
    code = ("import sys; sys.modules['jax'] = None; import runpy; sys.argv = ['x', 'render', "
            f"'--device', 'cpu', '--width', '8', '--height', '8', '--spp', '1', '--out', "
            f"{str(tmp_path / 'm.png')!r}]; runpy.run_module('mcrt_tpu_torch', "
            "run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "rendered 8x8" in r.stdout
    assert (tmp_path / "m.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
