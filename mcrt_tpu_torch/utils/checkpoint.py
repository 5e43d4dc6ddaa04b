"""Checkpoint and resume for progressive renders and inverse-rendering runs
(counterpart of ``mcrt_tpu/utils/checkpoint.py``).

The resumable state of a progressive render is its accumulator (the
filter-weighted radiance and weight sums and the samples taken), plus
whatever the caller adds (sampler bookkeeping, optimizer state).  Both
save as npz files in the JAX package's layout, so a checkpoint written by
either package loads in the other:

- ``save_accumulator``/``load_accumulator``: ``weighted``, ``weight``,
  ``frame`` and ``extra_<name>``, swapped in atomically (``os.replace``);
- ``save_pytree``/``restore_pytree``: a nest of tensors (tensor records,
  dicts, lists, tuples) flattened to keys named as the JAX package's
  ``jax.tree_util.tree_flatten_with_path`` names them: ``['key']`` for a
  dict entry (dicts in sorted key order), ``.field`` for a record's field,
  ``[i]`` for a list or tuple entry, joined by ``/``.

The JAX package saves pytrees with orbax where it is installed; orbax is
JAX-only, so the port writes npz alone and refuses an orbax directory.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ..core.types import default_device
from ..film.accumulate import Accumulator

_NUMBERS = (bool, int, float, np.generic)


def _leaves(tree: Any, prefix: str = ""):
    """(key, leaf) pairs of ``tree`` in the JAX package's flatten order: a
    leaf is a tensor, an array or a Python number; ``None`` holds none;
    other values (strings) are static and hold none either."""
    if isinstance(tree, (torch.Tensor, np.ndarray) + _NUMBERS):
        yield prefix, tree
        return
    sep = prefix + "/" if prefix else ""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{sep}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{sep}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{sep}.{f.name}")


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {k: _numpy(v) for k, v in _leaves(tree)}


def save_accumulator(path: str, accum: Accumulator, extra: dict | None = None):
    """Save render state as npz: the accumulator's sums and sample count,
    and each ``extra`` entry as ``extra_<name>``."""
    data = {"weighted": _numpy(accum.weighted), "weight": _numpy(accum.weight),
            "frame": np.asarray(accum.frame, np.int32)}
    for k, v in (extra or {}).items():
        data["extra_" + k] = _numpy(v)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **data)
    os.replace(tmp, path)  # atomic swap-in


def load_accumulator(path: str, device=None) -> tuple[Accumulator, dict]:
    """(accumulator on ``device``, the CUDA card unless named; {name: numpy
    array} of the extras)."""
    device = default_device(device)
    with np.load(path) as z:
        accum = Accumulator(weighted=torch.from_numpy(z["weighted"]).to(device),
                            weight=torch.from_numpy(z["weight"]).to(device),
                            frame=int(z["frame"]))
        extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
    return accum, extra


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree: Any) -> str:
    """Save a nest of tensors as an npz of its flattened leaves (at
    ``path``, ``.npz`` appended where missing); returns ``"npz"``."""
    np.savez_compressed(_npz(path), **_flatten(tree))
    return "npz"


def _rebuild(like: Any, arrays: dict, prefix: str = ""):
    sep = prefix + "/" if prefix else ""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arrays[prefix])).to(like.device, like.dtype)
    if isinstance(like, np.ndarray):
        return np.array(arrays[prefix], dtype=like.dtype)
    if isinstance(like, _NUMBERS):
        return type(like)(arrays[prefix].item())
    if isinstance(like, dict):
        return {k: _rebuild(v, arrays, f"{sep}[{k!r}]") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, arrays, f"{sep}[{i}]") for i, v in enumerate(like))
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), arrays, f"{sep}.{f.name}")
            for f in dataclasses.fields(like)})
    return like


def restore_pytree(path: str, like: Any) -> Any:
    """The nest saved at ``path`` with the structure, devices and dtypes of
    ``like``.  An orbax checkpoint (a directory) raises: orbax is JAX-only
    and the port reads npz."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory, an orbax checkpoint: orbax is JAX-only and "
                         "the port reads npz (save with the JAX package's npz path, or with "
                         "this module's save_pytree)")
    with np.load(_npz(path)) as z:
        arrays = {k: z[k] for k in z.files}
    missing = [k for k, _ in _leaves(like) if k not in arrays]
    if missing:
        raise KeyError(f"{path} has no leaves {missing}")
    return _rebuild(like, arrays)
