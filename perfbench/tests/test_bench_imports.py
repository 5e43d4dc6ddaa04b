"""What a run and the reference load: no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``mcrt_tpu`` (compared whole:
``mcrt_tpu_torch`` is the program), and the reference nothing of
``mcrt_tpu_torch`` either."""
import json
import os
import subprocess
import sys

from perfbench.run import BANNED

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.run import run_cell
r = run_cell("textured_hall.pt", 2**31 + 11, 0.5, False, device="cpu",
             overrides={{"render": {{"width": 8, "height": 8}}, "traffic": {{"check_pixels": 16}}}})
print(json.dumps([r["correct"], sorted({{m.split(".")[0] for m in sys.modules}})]))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from perfbench import scenes
from perfbench.refside import Reference
spec = scenes.load("textured_hall")
render = {{"width": 8, "height": 8, "sampler": {{"type": "sobol"}}, "integrator": {{"max_depth": 3}}}}
img = Reference().film(spec, render, torch.arange(64), [1024, 1025])
print(json.dumps([bool(torch.isfinite(img).all()), sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def _modules(code):
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_banned_names_are_whole_top_level_names():
    assert "mcrt_tpu" in BANNED and "mcrt_tpu_torch" not in BANNED


def test_a_run_loads_no_jax():
    correct, mods = _modules(RUN)
    assert correct
    assert "mcrt_tpu_torch" in mods
    assert not set(mods) & set(BANNED)


def test_the_reference_loads_nothing_of_the_program():
    finite, mods = _modules(REFERENCE)
    assert finite
    assert not set(mods) & (set(BANNED) | {"mcrt_tpu_torch"})


def test_only_the_program_door_imports_the_program():
    """``port.py`` and the loops are the program's callers; the reference,
    the scene generators and the arithmetic import none of it."""
    bench = os.path.join(ROOT, "perfbench")
    callers = {"port.py", "loops"}
    for dirpath, dirs, files in os.walk(bench):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        top = os.path.relpath(dirpath, bench).split(os.sep)[0]
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                src = fh.read()
            for banned in ("import jax", "from jax", "import mcrt_tpu\n", "from mcrt_tpu "):
                assert banned not in src, (f, banned)
            if f not in callers and top not in callers:
                assert "mcrt_tpu_torch" not in src.replace("``mcrt_tpu_torch``", ""), f
