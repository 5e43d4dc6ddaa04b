"""The port's public surface against the JAX package's.

A caller who replaces ``import mcrt_tpu`` with ``import mcrt_tpu_torch``
and keeps every other line should find every name the JAX package
documents at the same path and keyword.  The walk visits each module of
``mcrt_tpu`` (``pkgutil.walk_packages``, ``__main__`` left out since it
parses ``sys.argv`` at import) and its counterpart in the port, at the same
path except ``accel.pallas_blocked`` -> ``accel.blocked``.  A module's
public names are those it defines at top level (functions, classes,
assignments, found with ``ast``) and, for a package ``__init__``, those it
imports from the package.  For each it checks:

- the name resolves in the port; a re-export is the port's own object of
  the module that defines it;
- each keyword of a public function, method or class constructor is
  accepted by the port's signature;
- each public attribute of a public class (methods, properties, dataclass
  fields, classmethods) exists on the port's class;
- each module-level number or string constant is equal.

``DEPARTURES`` is the one list of the gaps the port keeps, each with its
reason; an entry that no longer names a gap fails, so the list cannot go
stale.  Beside the walk, value checks hold the names this surface gained
(``Hit.none``, the constants, ``transform_point``/``transform_vector``'s
keywords, ``device_memory_stats(index=)``, ``BufferManager``, ``get_lib``,
``Vertices.at``, ``.replace``, and the card default of ``Hit.none``,
``Accumulator.zeros`` and ``sobol_matrices``) against the JAX package on seeded numpy inputs.
"""
import ast
import dataclasses
import enum
import functools
import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcrt_tpu
from mcrt_tpu.core import math as jm
from mcrt_tpu.core import types as jtypes
from mcrt_tpu.runtime import platform as jplatform
from mcrt_tpu_torch.core import math as tm
from mcrt_tpu_torch.core import types as ttypes

torch.set_num_threads(1)

RNG = np.random.default_rng(20261017)

# JAX module -> the port's module, where the two paths differ
MODULE_MAP = {"accel.pallas_blocked": "accel.blocked"}

# Every gap the port keeps, keyed "module:name", "module:Class.attr" or
# "module:callable(keyword)", with its reason.
DEPARTURES = {
    "accel.pallas_blocked:TILE":
        "the port picks its own ray tile for its CUDA kernels (128 rays); 256 was tuned "
        "for the TPU",
    "accel.pallas_blocked:DTILE":
        "the dense kernels K4/K5 take one ray a thread, with no ray tile to set",
    "accel.pallas_blocked:MAX_SMEM_CHUNKS":
        "the TPU cull's limit on chunks held in scalar memory; the CUDA cull has no such "
        "store",
    "accel.lbvh:LBVH(packed_t)":
        "the LBVH stores row-major `packed`; `packed_t`, the TPU's transposed layout, is "
        "a property",
    "accel.lbvh:LBVH(children)":
        "the LBVH stores row-major `child`; `children` is a property",
    "accel.lbvh:LBVH(leaf_t)":
        "the LBVH stores row-major `leaf_rows`; `leaf_t` is a property",
    "accel.lbvh:LBVH(unified_t)":
        "the LBVH stores row-major `unified`; `unified_t` is a property",
    "accel.lbvh:LBVH(unified_ci)":
        "the LBVH stores row-major `unified_child`; `unified_ci` is a property",
    "parallel.mesh:replicated":
        "a NamedSharding helper: the port's mesh is over process-group ranks, with no "
        "sharding objects",
    "parallel.mesh:rays_sharding":
        "a NamedSharding helper: the port shards by rank, with no sharding objects",
    "parallel.mesh:spp_rays_sharding":
        "a NamedSharding helper: the port shards by rank, with no sharding objects",
    "parallel.mesh:make_mesh(devices)":
        "the mesh is over the process group's ranks; `device=` names their device type",
    "parallel.ring:shard_map":
        "JAX's shard_map shim; the ring runs one process a rank under torch.distributed",
    "sampling.rng:SampleStream.key":
        "a threefry key; the port carries `seed` and derives the same counters from it",
    "integrators.bdpt:Vertices.empty":
        "a walk records each vertex as its own `Vertex` and stacks them once it ends: "
        "autograd refuses writes into a saved record",
    "integrators.bdpt:Vertices.set_vertex":
        "writes a vertex in place into the stacked record, which autograd refuses; "
        "`Vertex.set` edits a vertex before the stack",
}


def _jax_modules() -> list[str]:
    names = [""]
    for info in pkgutil.walk_packages(mcrt_tpu.__path__, "mcrt_tpu."):
        if not info.name.endswith("__main__"):
            names.append(info.name[len("mcrt_tpu."):])
    return names


JAX_MODULES = _jax_modules()


def _jax_module(rel: str):
    return importlib.import_module("mcrt_tpu" + ("." + rel if rel else ""))


def _port_module(rel: str):
    rel = MODULE_MAP.get(rel, rel)
    return importlib.import_module("mcrt_tpu_torch" + ("." + rel if rel else ""))


def _public_names(rel: str, mod) -> tuple[set[str], dict[str, tuple[str, str]]]:
    """The public names module ``rel`` defines at top level, and those a
    package __init__ imports from the package, each with the module it
    comes from and its name there."""
    defined, imported = set(), {}
    is_pkg = hasattr(mod, "__path__")

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                defined.add(node.name)
            elif isinstance(node, ast.Assign):
                defined.update(e.id for t in node.targets for e in ast.walk(t)
                               if isinstance(e, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                defined.add(node.target.id)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for h in getattr(node, "handlers", []):
                    visit(h.body)
            elif is_pkg and isinstance(node, ast.ImportFrom) and node.level > 0:
                parts = rel.split(".") if rel else []
                parts = parts[:len(parts) - (node.level - 1)]
                src = ".".join(parts + ([node.module] if node.module else []))
                for a in node.names:
                    imported[a.asname or a.name] = (src, a.name)

    with open(mod.__file__) as f:
        visit(ast.parse(f.read()).body)
    return ({n for n in defined if not n.startswith("_")},
            {n: v for n, v in imported.items() if not n.startswith("_")})


def _is_constant(obj) -> bool:
    return isinstance(obj, (bool, int, float, str, np.generic)) and \
        not isinstance(obj, enum.Enum)


def _keywords(fn) -> tuple[set[str], bool] | None:
    """The names ``fn`` takes by keyword, and whether it takes any
    (``**kw``); None where its signature cannot be read."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    return ({p.name for p in params if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)},
            any(p.kind is p.VAR_KEYWORD for p in params))


def _keyword_gaps(label: str, jfn, pfn) -> dict[str, str]:
    jsig, psig = _keywords(jfn), _keywords(pfn)
    if jsig is None:
        return {}
    if psig is None:
        return {label: "signature cannot be read in the port"}
    if psig[1]:
        return {}
    return {f"{label}({k})": "keyword not accepted" for k in sorted(jsig[0] - psig[0])}


def _field_names(cls) -> set[str]:
    names = set(getattr(cls, "_fields", ()))
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


def _class_gaps(prefix: str, jcls, pcls) -> dict[str, str]:
    gaps = {}
    pfields = _field_names(pcls)
    attrs = {a for a in dir(jcls) if not a.startswith("_")} | _field_names(jcls)
    for a in sorted(attrs):
        if not hasattr(pcls, a) and a not in pfields:
            gaps[f"{prefix}.{a}"] = "attribute missing"
            continue
        static = inspect.getattr_static(jcls, a, None)
        if isinstance(static, (classmethod, staticmethod)) or inspect.isfunction(static):
            pattr = getattr(pcls, a, None)
            if callable(pattr):
                gaps.update(_keyword_gaps(f"{prefix}.{a}", getattr(jcls, a), pattr))
    if not issubclass(jcls, enum.Enum):
        for key, why in _keyword_gaps(prefix, jcls, pcls).items():
            # a constructor keyword that is a missing attribute is one gap
            if f"{prefix}.{key[len(prefix) + 1:-1]}" not in gaps:
                gaps[key] = why
    return gaps


@functools.lru_cache(maxsize=None)
def _gaps(rel: str) -> dict[str, str]:
    """Every gap of the port's counterpart of JAX module ``rel``."""
    jmod = _jax_module(rel)
    try:
        pmod = _port_module(rel)
    except ImportError as e:
        return {f"{rel}:": f"no module: {e}"}
    defined, imported = _public_names(rel, jmod)
    gaps = {}
    for name in sorted(defined | set(imported)):
        key, jobj = f"{rel}:{name}", getattr(jmod, name)
        if not hasattr(pmod, name):
            gaps[key] = "name missing"
            continue
        pobj = getattr(pmod, name)
        if _is_constant(jobj):
            if not (_is_constant(pobj) and np.array_equal(np.asarray(jobj), np.asarray(pobj))):
                gaps[key] = f"value {jobj!r} in JAX, {pobj!r} in the port"
        elif name in imported and name not in defined:
            src, orig = imported[name]
            if pobj is not getattr(_port_module(src), orig, None):
                gaps[key] = f"re-exports another object than the port's {src}.{orig}"
        elif inspect.isclass(jobj):
            if not inspect.isclass(pobj):
                gaps[key] = "not a class in the port"
            else:
                gaps.update(_class_gaps(key, jobj, pobj))
        elif callable(jobj):
            gaps.update(_keyword_gaps(key, jobj, pobj))
    return gaps


# --------------------------------------------------------------------------
# The walk
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rel", JAX_MODULES, ids=lambda r: r or "mcrt_tpu")
def test_public_names_resolve_in_port(rel):
    """Every public name, keyword and class attribute of JAX module ``rel``
    resolves in the port, apart from the listed departures."""
    gaps = {k: v for k, v in _gaps(rel).items() if k not in DEPARTURES}
    assert not gaps, f"the port lacks: {gaps}"


@pytest.mark.parametrize("key", sorted(DEPARTURES))
def test_departure_still_names_a_gap(key):
    """A departure the port has since closed must leave the list."""
    rel = key.split(":")[0]
    assert rel in JAX_MODULES, f"{key}: no such JAX module"
    assert key in _gaps(rel), f"{key} is no longer a gap: remove it from DEPARTURES"


# --------------------------------------------------------------------------
# Value checks of the names this surface gained
# --------------------------------------------------------------------------


def _fields_equal(t, j):
    """Every dataclass field of ``t`` equals ``j``'s, dtype included."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        assert tv.dtype == jv.dtype, f.name
        np.testing.assert_array_equal(tv, jv, err_msg=f.name)


def test_hit_none_matches_jax():
    hit = ttypes.Hit.none(7, device="cpu")
    assert hit.t.device.type == "cpu"
    _fields_equal(hit, jtypes.Hit.none(7))


@pytest.mark.parametrize("path", ["core.math:EPS", "bsdf.uber:N_LOBES",
                                  "bsdf.materials:N_TEX_SLOTS", ":__version__"])
def test_constants_match_jax(path):
    rel, name = path.split(":")
    jval, tval = getattr(_jax_module(rel), name), getattr(_port_module(rel), name)
    assert type(tval) is type(jval) and tval == jval


@pytest.mark.parametrize("fn,arg", [("transform_point", "p"), ("transform_vector", "v")])
def test_transform_keywords_match_jax(fn, arg):
    mat = RNG.normal(size=(5, 4, 4)).astype(np.float32)
    x = RNG.normal(size=(5, 3)).astype(np.float32)
    want = np.asarray(getattr(jm, fn)(m=jnp.asarray(mat), **{arg: jnp.asarray(x)}))
    got = getattr(tm, fn)(m=torch.from_numpy(mat), **{arg: torch.from_numpy(x)})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_device_memory_stats_index_keyword():
    from mcrt_tpu_torch.runtime import device_memory_stats

    if torch.cuda.is_available():
        assert device_memory_stats(index=0).keys() == device_memory_stats(0).keys()
    else:
        assert device_memory_stats(index=0) == device_memory_stats(0) == {}
    assert device_memory_stats(index=torch.device("cpu")) == {}


def test_buffer_manager_matches_jax():
    from mcrt_tpu_torch.runtime import BufferManager

    trees = [{"pos": RNG.normal(size=(4096, 3)).astype(np.float32),
              "idx": RNG.integers(0, 4096, size=(2048, 3)).astype(np.int32)},
             {"tex": RNG.uniform(size=(256, 256, 4)).astype(np.float32)},
             {"ids": RNG.integers(0, 9, size=(777,)).astype(np.int32)}]
    jbm, tbm = jplatform.BufferManager(), BufferManager()
    for name, tree in zip(("scene", "textures", "scene"), trees):
        assert tbm.register(name, {k: torch.from_numpy(v) for k, v in tree.items()}) == \
            jbm.register(name, {k: jnp.asarray(v) for k, v in tree.items()})
    jbm.release("textures")
    tbm.release("textures")
    assert (tbm.total, tbm.max_total, tbm.contexts) == (jbm.total, jbm.max_total, jbm.contexts)
    assert tbm.report() == jbm.report()


def test_get_lib_matches_available():
    from mcrt_tpu_torch.runtime import native

    lib = native.get_lib()
    assert (lib is not None) == native.available()
    assert lib is None or lib is native.get_lib()


def test_vertices_at_is_the_recorded_vertex(monkeypatch):
    """``Vertices.at(i)`` of a camera subpath equals the ``Vertex`` the walk
    recorded at ``i``."""
    from mcrt_tpu_torch.accel import build_intersector
    from mcrt_tpu_torch.camera.pinhole import pixel_uv
    from mcrt_tpu_torch.config import IntegratorConfig, RenderConfig, SamplerConfig
    from mcrt_tpu_torch.integrators import bdpt
    from mcrt_tpu_torch.sampling import rng
    from mcrt_tpu_torch.scene.builders import cornell_box

    scene, camera = cornell_box(device="cpu")
    o, d = camera.generate_rays(pixel_uv(4, 4, device="cpu"))
    recorded = []
    stack = bdpt.Vertices.stack.__func__
    monkeypatch.setattr(bdpt.Vertices, "stack", classmethod(
        lambda cls, verts: recorded.extend(verts) or stack(cls, verts)))
    isect = build_intersector(scene, RenderConfig(width=4, height=4))
    with torch.no_grad():
        verts, _, _ = bdpt.generate_camera_subpath(
            scene, camera, ttypes.Rays.make(o, d), rng.make_stream(SamplerConfig(), 0,
                                                                    torch.arange(16)),
            3, IntegratorConfig(max_depth=2), isect.intersect)
    assert len(recorded) == 3 and bool(recorded[1].valid.any())
    for i, want in enumerate(recorded):
        got = verts.at(i)
        assert type(got) is bdpt.Vertex
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), (i, f.name)


def test_sample_stream_replace_keeps_other_fields():
    from mcrt_tpu_torch.config import SamplerConfig, SamplerType
    from mcrt_tpu_torch.sampling import rng

    stream = rng.make_stream(SamplerConfig(type=SamplerType.SOBOL), 3, torch.arange(8))
    out = stream.replace(dim=5)
    assert out.dim == 5 and stream.dim == 0
    for f in dataclasses.fields(stream):
        if f.name != "dim":
            assert getattr(out, f.name) is getattr(stream, f.name), f.name


def test_scene_animator_replace_keeps_other_fields():
    from mcrt_tpu_torch.scene.builders import cornell_box
    from mcrt_tpu_torch.scene.dynamic import SceneAnimator

    anim = SceneAnimator.create(cornell_box(device="cpu")[0])
    shapes = torch.zeros_like(anim.vertex_shape)
    out = anim.replace(vertex_shape=shapes)
    assert out.vertex_shape is shapes and out.base is anim.base
    assert anim.vertex_shape is not shapes


@pytest.mark.parametrize("make", ["Accumulator.zeros", "Hit.none", "sobol_matrices"])
def test_entry_points_default_to_the_card(make, monkeypatch):
    """Without a device these entry points place their tensors on the card,
    as the JAX ones do on the default accelerator: without a card they
    raise ``default_device``'s error, and run on the CPU only when asked."""
    from mcrt_tpu_torch.film.accumulate import Accumulator
    from mcrt_tpu_torch.sampling.sobol import sobol_matrices

    fn = {"Accumulator.zeros": lambda **kw: Accumulator.zeros(4, 4, **kw).weighted,
          "Hit.none": lambda **kw: ttypes.Hit.none(4, **kw).t,
          "sobol_matrices": lambda **kw: sobol_matrices(**kw)}[make]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn()
    assert fn(device="cpu").device.type == "cpu"
