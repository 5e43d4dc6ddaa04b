"""Command-line interface (counterpart of ``mcrt_tpu/cli.py``):

    python -m mcrt_tpu_torch render --scene cornell_box --out out.png --spp 64
    python -m mcrt_tpu_torch render --config render.yaml --obj scene.obj
    python -m mcrt_tpu_torch view --scene cornell_box --port 8000
    python -m mcrt_tpu_torch info

Every command runs on the CUDA card unless ``--device`` names another
(``--device cpu``).  The scenes ``bunny_field``, ``heavy_gallery`` and
``bunny_field_instanced`` read ``bunny.obj`` from ``$MCRT_ASSETS``; without
it the command exits non-zero with the builder's message.  ``--config``
reads a YAML ``RenderConfig`` and needs PyYAML.  ``view`` serves the
progressive viewer (``viewer.py``) until interrupted (SIGINT, Ctrl-C).  ``bench`` (the port's benchmark) is not
written yet and raises.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

# the last three read bunny.obj from $MCRT_ASSETS (scene/builders.py: _asset_path)
SCENES = ("cornell_box", "glass_gallery", "textured_hall", "instanced_boxes", "sphere_field",
          "sphere_field_instanced", "bunny_field", "heavy_gallery", "bunny_field_instanced")


def _load_config(args):
    from .config import IntegratorType, RenderConfig, from_dict, replace

    if args.config:
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(f"--config {args.config} needs PyYAML, which is not installed; "
                               "pass the settings as flags instead") from e
        with open(args.config) as f:
            cfg = from_dict(yaml.safe_load(f) or {})
    else:
        cfg = RenderConfig()
    over = {k: v for k, v in (("width", args.width), ("height", args.height),
                              ("spp", args.spp)) if v}
    if over:
        cfg = replace(cfg, **over)
    integ = {}
    if args.max_depth:
        integ["max_depth"] = args.max_depth
    if args.integrator:
        integ["type"] = IntegratorType(args.integrator)
    if integ:
        cfg = replace(cfg, integrator=replace(cfg.integrator, **integ))
    return cfg


def _load_scene(args, device):
    from .scene import builders

    if args.obj:
        return builders.scene_from_obj(args.obj, device=device)
    if args.scene not in SCENES:
        sys.exit(f"unknown scene {args.scene!r}; use one of {', '.join(SCENES)} "
                 "or --obj FILE")
    try:
        return getattr(builders, args.scene)(device=device)
    except FileNotFoundError as e:  # a scene whose asset is missing
        sys.exit(f"{args.scene}: {e}")


def cmd_render(args) -> int:
    from .core.types import default_device
    from .renderer import Renderer
    from .utils.image import write_png

    device = default_device(args.device)
    cfg = _load_config(args)
    scene, camera = _load_scene(args, device)
    t0 = time.time()
    r = Renderer(scene, camera, cfg, device=device)
    if args.progressive:
        # write the accumulated image every --progressive spp, so that
        # convergence can be watched (the progressive viewer's stand-in)
        interval = max(args.progressive, cfg.samples_per_pass)
        next_dump = interval
        while r.accum.frame < cfg.spp and not r.stopped():
            r.step(1)
            done = r.accum.frame
            if done >= next_dump or done >= cfg.spp:
                write_png(args.out, r.display_image())
                print(f"  {done}/{cfg.spp} spp ({time.time() - t0:.1f}s) -> {args.out}",
                      flush=True)
                next_dump += interval
        img = r.display_image()
    else:
        img = r.render()
    img = img.cpu()  # waits for the device
    dt = time.time() - t0
    write_png(args.out, img)
    n_rays = cfg.width * cfg.height * cfg.spp * (cfg.integrator.max_depth + 1)
    print(f"rendered {cfg.width}x{cfg.height} @ {cfg.spp} spp on {device} in {dt:.2f}s "
          f"(~{n_rays / dt / 1e6:.1f} Mrays/s upper bound) -> {args.out}")
    return 0


def cmd_view(args) -> int:
    """Serve the accumulating render over HTTP with its edit loops until
    interrupted; the viewer is stopped and its socket closed either way."""
    from .core.types import default_device
    from .renderer import Renderer
    from .viewer import ProgressiveViewer

    device = default_device(args.device)
    cfg = _load_config(args)
    scene, camera = _load_scene(args, device)
    r = Renderer(scene, camera, cfg, device=device)
    v = ProgressiveViewer(r, host=args.host, port=args.port,
                          scene_name="custom" if args.obj else args.scene)
    print(f"serving http://{args.host}:{v.port}/ ({cfg.width}x{cfg.height}, progressive, "
          f"on {device})", flush=True)
    # SIGINT stops the viewer even where it was started with SIGINT ignored
    # (in the background of a non-interactive shell)
    own = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGINT, signal.default_int_handler) if own else None
    try:
        v.serve()
    except KeyboardInterrupt:
        pass
    finally:
        v.stop()
        if own:
            signal.signal(signal.SIGINT, previous)
    return 0


def cmd_bench(args) -> int:
    raise NotImplementedError("the port's benchmark is not written yet (ROADMAP, W1: the "
                              "port's bench)")


def cmd_info(args) -> int:
    import torch

    from .runtime.native import available
    from .runtime.platform import device_memory_stats, enumerate_devices

    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    for d in enumerate_devices():
        mem = f"{d.memory_bytes / 2**30:.1f} GiB" if d.memory_bytes else "?"
        print(f"  device {d.index}: {d.kind} ({d.platform}), memory {mem}")
    stats = device_memory_stats(0)
    if stats:
        print(f"  bytes in use: {stats['bytes_in_use'] / 2**20:.1f} MiB")
    print(f"native library: {'available' if available() else 'absent'}")
    return 0


def _scene_args(p):
    p.add_argument("--scene", default="cornell_box", help=f"built-in scene ({', '.join(SCENES)})")
    p.add_argument("--obj", default=None, help="OBJ file to render")
    p.add_argument("--config", default=None, help="YAML RenderConfig (needs PyYAML)")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--spp", type=int, default=0)
    p.add_argument("--max-depth", type=int, default=0)
    p.add_argument("--integrator", choices=["path", "bdpt"], default=None)
    p.add_argument("--progressive", type=int, default=0, metavar="N",
                   help="write the accumulated image every N spp")
    p.add_argument("--device", default=None,
                   help="torch device to render on (default: the CUDA card)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mcrt_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    _scene_args(pr)
    pr.add_argument("--out", default="render.png")
    pr.set_defaults(fn=cmd_render)

    pv = sub.add_parser("view", help="progressive HTTP viewer with edits")
    _scene_args(pv)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8000)
    pv.set_defaults(fn=cmd_view)

    pi = sub.add_parser("info", help="devices and runtime")
    pi.set_defaults(fn=cmd_info)

    pb = sub.add_parser("bench", help="the benchmark (not written yet)")
    pb.add_argument("--scene", default=None)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
