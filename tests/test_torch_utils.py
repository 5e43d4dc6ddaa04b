"""The port's checkpoint and profiling utilities (``mcrt_tpu_torch/utils/
{checkpoint,profiling}.py``) and ``runtime/platform.py``'s byte count.

- Checkpoints cross between the packages: an accumulator saved by either
  package's ``save_accumulator`` loads in the other's ``load_accumulator``
  (arrays equal, frame and extras kept), and a ``full_params`` tree and a
  nest holding an accumulator saved by either ``save_pytree`` (the JAX
  package's npz path, orbax made unimportable) restore in the other's
  ``restore_pytree``; the JAX package's ``_flatten`` keys equal the
  port's.  A progressive render saved after 2 frames and resumed in a
  fresh ``Renderer`` equals 4 uninterrupted frames bit for bit.  An orbax
  directory is refused with the reason.
- The profiler's span nesting, counts and report; ``device_trace`` writes
  a Chrome trace that names the spans; ``device_memory_stats`` is empty on
  the CPU.
"""
from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from mcrt_tpu_torch import Renderer, RenderConfig
from mcrt_tpu_torch.config import IntegratorConfig
from mcrt_tpu_torch.diff import estimators as E
from mcrt_tpu_torch.film.accumulate import Accumulator
from mcrt_tpu_torch.runtime.platform import nbytes
from mcrt_tpu_torch.scene import builders
from mcrt_tpu_torch.utils import checkpoint, profiling

torch.set_num_threads(1)


def _accum(seed=0, frame=5):
    gen = np.random.default_rng(seed)
    return (gen.random((6, 4, 3), dtype=np.float32), gen.random((6, 4), dtype=np.float32),
            frame)


def _jax_no_orbax(monkeypatch):
    """The JAX package's checkpoint module with orbax unimportable, so its
    ``save_pytree`` takes its npz path."""
    from mcrt_tpu.utils import checkpoint as jck

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    return jck


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------


def test_accumulator_written_by_jax_loads_in_the_port(tmp_path):
    import jax.numpy as jnp

    from mcrt_tpu.film.accumulate import Accumulator as JAccumulator
    from mcrt_tpu.utils import checkpoint as jck

    weighted, weight, frame = _accum()
    path = str(tmp_path / "j.npz")
    jck.save_accumulator(path, JAccumulator(weighted=jnp.asarray(weighted),
                                            weight=jnp.asarray(weight),
                                            frame=jnp.asarray(frame, jnp.int32)),
                         extra={"seed": np.int64(1234)})
    acc, extra = checkpoint.load_accumulator(path, device="cpu")
    assert torch.equal(acc.weighted, torch.from_numpy(weighted))
    assert torch.equal(acc.weight, torch.from_numpy(weight))
    assert acc.frame == frame and isinstance(acc.frame, int)
    assert int(extra["seed"]) == 1234


def test_accumulator_written_by_the_port_loads_in_jax(tmp_path):
    from mcrt_tpu.utils import checkpoint as jck

    weighted, weight, frame = _accum(1, 9)
    path = str(tmp_path / "t.npz")
    checkpoint.save_accumulator(path, Accumulator(weighted=torch.from_numpy(weighted),
                                                  weight=torch.from_numpy(weight), frame=frame),
                                extra={"frames": torch.arange(3)})
    assert os.listdir(tmp_path) == ["t.npz"]  # the temporary file was swapped in
    acc, extra = jck.load_accumulator(path)
    np.testing.assert_array_equal(np.asarray(acc.weighted), weighted)
    np.testing.assert_array_equal(np.asarray(acc.weight), weight)
    assert int(acc.frame) == frame
    np.testing.assert_array_equal(extra["frames"], [0, 1, 2])


def _trees():
    """(port tree, JAX tree) of the same arrays: the ``full_params`` of
    ``cornell_box`` and a nest with an accumulator, a list and a None."""
    import jax.numpy as jnp

    from mcrt_tpu.diff import estimators as JE
    from mcrt_tpu.film.accumulate import Accumulator as JAccumulator
    from mcrt_tpu.scene import builders as jb

    jparams = JE.full_params().get(jb.cornell_box()[0])
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    weighted, weight, frame = _accum(2, 3)
    jnest = {"acc": JAccumulator(weighted=jnp.asarray(weighted), weight=jnp.asarray(weight),
                                 frame=jnp.asarray(frame, jnp.int32)),
             "steps": [jnp.arange(4), None, jnp.float32(0.5)]}
    tnest = {"acc": Accumulator(weighted=torch.from_numpy(weighted),
                                weight=torch.from_numpy(weight), frame=frame),
             "steps": [torch.arange(4), None, 0.5]}
    return {"params": (tparams, jparams), "nest": (tnest, jnest)}


def _zeros_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    if isinstance(tree, Accumulator):
        return Accumulator(weighted=_zeros_like(tree.weighted),
                           weight=_zeros_like(tree.weight), frame=0)
    return type(tree)(0) if tree is not None else None


def _assert_same(t, j):
    from mcrt_tpu.utils.checkpoint import _flatten as j_flatten

    tf, jf = checkpoint._flatten(t), j_flatten(j)
    assert list(tf) == list(jf)
    for k in tf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)


@pytest.mark.parametrize("name", ["params", "nest"])
def test_pytree_written_by_jax_restores_in_the_port(tmp_path, monkeypatch, name):
    jck = _jax_no_orbax(monkeypatch)
    tree, jtree = _trees()[name]
    path = str(tmp_path / "tree")
    assert jck.save_pytree(path, jtree) == "npz"
    got = checkpoint.restore_pytree(path, _zeros_like(tree))
    _assert_same(got, jtree)
    if name == "nest":
        assert isinstance(got["acc"], Accumulator) and got["acc"].frame == 3
        assert got["steps"][1] is None


@pytest.mark.parametrize("name", ["params", "nest"])
def test_pytree_written_by_the_port_restores_in_jax(tmp_path, monkeypatch, name):
    import jax

    jck = _jax_no_orbax(monkeypatch)
    tree, jtree = _trees()[name]
    path = str(tmp_path / "tree.npz")
    assert checkpoint.save_pytree(path, tree) == "npz"
    got = jck.restore_pytree(path, jax.tree_util.tree_map(lambda x: x * 0, jtree))
    _assert_same(tree, got)


def test_restore_pytree_refuses_an_orbax_directory(tmp_path):
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match="orbax is JAX-only"):
        checkpoint.restore_pytree(str(tmp_path / "ckpt"), {"a": torch.zeros(1)})


def test_progressive_render_resumes_bit_for_bit(tmp_path):
    scene, camera = builders.cornell_box(device="cpu")
    cfg = RenderConfig(width=12, height=10, integrator=IntegratorConfig(max_depth=2))
    whole = Renderer(scene, camera, cfg, device="cpu")
    whole.step(4)
    first = Renderer(scene, camera, cfg, device="cpu")
    first.step(2)
    path = str(tmp_path / "acc.npz")
    checkpoint.save_accumulator(path, first.accum)
    resumed = Renderer(scene, camera, cfg, device="cpu")
    resumed.accum, _ = checkpoint.load_accumulator(path, device="cpu")
    resumed.step(2)
    assert resumed.accum.frame == 4
    assert torch.equal(resumed.accum.weighted, whole.accum.weighted)
    assert torch.equal(resumed.accum.weight, whole.accum.weight)


def test_nbytes_counts_every_tensor_of_a_record():
    scene, _ = builders.cornell_box(device="cpu")
    params = E.full_params().get(scene)
    assert nbytes(params) == sum(v.numel() * v.element_size() for v in params.values())
    assert nbytes(scene) > nbytes(scene.geometry) > 0
    assert nbytes({"a": [torch.zeros(3, dtype=torch.float64), None, 4]}) == 24


# --------------------------------------------------------------------------
# Profiling
# --------------------------------------------------------------------------


def test_profiler_spans_nest_and_count():
    prof = profiling.Profiler(history=3)
    for _ in range(5):
        with prof.span("frame", sync=torch.zeros(1)):
            with prof.span("trace"):
                pass
            with prof.span("accumulate"):
                pass
    with prof.span("frame"):
        pass
    stats = prof.stats()
    assert set(stats) == {"frame", "frame/trace", "frame/accumulate"}
    assert stats["frame"].count == 6 and stats["frame/trace"].count == 5
    assert len(stats["frame"].history) == 3  # bounded
    s = stats["frame"]
    assert s.max_s >= s.avg_s >= 0 and abs(s.total_s - s.avg_s * s.count) < 1e-12
    report = prof.report().splitlines()
    assert report[0].split()[:2] == ["span", "count"]
    assert [ln.split()[0] for ln in report[1:]] == sorted(stats)
    prof.reset()
    assert prof.stats() == {}


def test_span_records_after_an_exception():
    prof = profiling.Profiler()
    with pytest.raises(RuntimeError):
        with prof.span("outer"):
            with prof.span("inner"):
                raise RuntimeError("inside")
    assert set(prof.stats()) == {"outer", "outer/inner"}
    with prof.span("next"):  # the stack unwound
        pass
    assert "next" in prof.stats()


def test_device_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    prof = profiling.Profiler()
    with profiling.device_trace(str(tmp_path / "trace")):
        with prof.span("render_span"):
            torch.ones(64).cumsum(0)
    files = glob.glob(str(tmp_path / "trace" / "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "render_span" for e in events)


def test_memory_stats_and_metrics_on_the_cpu():
    from mcrt_tpu_torch.runtime import platform

    assert profiling.device_memory_stats() == {}
    assert platform.device_memory_stats(torch.device("cpu")) == {}
    m = profiling.RenderMetrics(rays_traced=2e6, samples=4, render_s=0.5)
    assert m.rays_per_sec() == 4e6
    assert profiling.RenderMetrics().rays_per_sec() == 0.0
    assert isinstance(profiling.profiler, profiling.Profiler)
