"""Device discovery and memory accounting (counterpart of
``mcrt_tpu/runtime/platform.py``): ``enumerate_devices`` and
``device_memory_stats`` read ``torch.cuda``; ``nbytes`` counts the bytes of
the tensors in a record (the JAX package's ``_nbytes``); ``BufferManager``
keeps named byte totals of tensors (tensor records, dicts, lists) with the
largest total seen, and ``buffers`` is the process-wide one."""
from __future__ import annotations

import dataclasses
import platform as _platform
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class DeviceInfo:
    index: int
    platform: str
    kind: str
    memory_bytes: int | None  # device memory, where known


def enumerate_devices() -> list[DeviceInfo]:
    """The CUDA cards, or the CPU alone where there is none."""
    if not torch.cuda.is_available():
        return [DeviceInfo(index=0, platform="cpu", kind=_platform.processor() or "cpu",
                           memory_bytes=None)]
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append(DeviceInfo(index=i, platform="gpu", kind=props.name,
                              memory_bytes=int(props.total_memory)))
    return out


def device_memory_stats(index=0) -> dict:
    """One card's memory: ``bytes_in_use`` and ``peak_bytes_in_use`` (the
    caching allocator's live tensors, ``torch.cuda.memory_stats``),
    ``bytes_reserved`` (held by the allocator) and ``bytes_limit`` (the
    card's memory, ``torch.cuda.mem_get_info``).  ``index`` is a card's
    index (the JAX package's keyword) or a torch device.  Empty for a CPU
    device or without a card."""
    device = index
    if not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return {}
        device = torch.cuda.current_device() if device.index is None else device.index
    if not torch.cuda.is_available() or device >= torch.cuda.device_count():
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(total)}


def nbytes(tree) -> int:
    """Bytes of every tensor in a tensor, tensor record, dict, list or
    tuple (nested)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(nbytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return 0


@dataclass
class BufferManager:
    """Named allocation contexts with their byte totals and the largest
    total seen."""

    contexts: dict[str, int] = field(default_factory=dict)
    max_total: int = 0

    def register(self, name: str, tree) -> int:
        """Track the tensors of ``tree`` under ``name``; returns their bytes."""
        size = nbytes(tree)
        self.contexts[name] = self.contexts.get(name, 0) + size
        self.max_total = max(self.max_total, self.total)
        return size

    def release(self, name: str) -> None:
        self.contexts.pop(name, None)

    @property
    def total(self) -> int:
        return sum(self.contexts.values())

    def report(self) -> str:
        lines = [f"  {name:<24} {size / 2**20:8.2f} MiB"
                 for name, size in sorted(self.contexts.items())]
        lines.append(f"  {'TOTAL':<24} {self.total / 2**20:8.2f} MiB"
                     f" (max {self.max_total / 2**20:.2f})")
        return "\n".join(lines)


# the process-wide manager, as the JAX package's
buffers = BufferManager()
