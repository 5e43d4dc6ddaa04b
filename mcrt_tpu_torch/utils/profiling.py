"""Profiling spans and renderer metrics (counterpart of
``mcrt_tpu/utils/profiling.py``).

- host spans: a registry of named, nested spans with per-span count, last,
  average and maximum times and a bounded history (``Profiler``, and the
  module-level ``profiler``);
- device time: ``span(..., sync=tensor)`` waits for the tensor's card
  (``torch.cuda.synchronize``, the counterpart of
  ``jax.block_until_ready``), and every span is a
  ``torch.profiler.record_function`` range (the counterpart of
  ``jax.named_scope``), so it names its work in a ``device_trace``;
- ``device_trace(log_dir)``: a ``torch.profiler`` trace of the block,
  written to ``log_dir`` as a Chrome trace (the counterpart of
  ``jax.profiler.start_trace``);
- ``device_memory_stats``: each card's allocator statistics;
- ``RenderMetrics``: rays/s over the rendered samples.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    last_s: float = 0.0
    history: list = field(default_factory=list)

    @property
    def avg_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Profiler:
    """Named span registry. Spans nest: a span opened inside another is
    recorded under ``outer/inner``."""

    def __init__(self, history: int = 64):
        self._stats: dict[str, SpanStats] = defaultdict(SpanStats)
        self._stack: list[str] = []
        self._history = history

    @contextlib.contextmanager
    def span(self, name: str, sync: torch.Tensor | None = None):
        """Time a host-side span.  Card work is asynchronous: without
        ``sync`` the span times only the queuing of its work; with a tensor
        on a card, the span ends when that card has finished its work."""
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if sync is not None and sync.is_cuda:
                torch.cuda.synchronize(sync.device)
            dt = time.perf_counter() - t0
            self._stack.pop()
            s = self._stats[path]
            s.count += 1
            s.total_s += dt
            s.last_s = dt
            s.max_s = max(s.max_s, dt)
            s.history.append(dt)
            if len(s.history) > self._history:
                s.history.pop(0)

    def stats(self) -> dict[str, SpanStats]:
        return dict(self._stats)

    def report(self) -> str:
        lines = [f"{'span':40s} {'count':>6s} {'last ms':>9s} {'avg ms':>9s} {'max ms':>9s}"]
        for name in sorted(self._stats):
            s = self._stats[name]
            lines.append(f"{name:40s} {s.count:6d} {s.last_s * 1e3:9.2f} "
                         f"{s.avg_s * 1e3:9.2f} {s.max_s * 1e3:9.2f}")
        return "\n".join(lines)

    def reset(self):
        self._stats.clear()


# module-level default profiler
profiler = Profiler()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host ranges, and the cards'
    kernels where there is a card) and write it to ``log_dir`` as a Chrome
    trace, ``trace-<time>-<pid>.json``.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"))


def device_memory_stats() -> dict:
    """Every card's memory (``runtime.platform.device_memory_stats``), keyed
    ``cuda:<index>``; empty without a card."""
    from ..runtime.platform import device_memory_stats as one

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": one(i) for i in range(torch.cuda.device_count())}


@dataclass
class RenderMetrics:
    """Rolling renderer metrics: rays traced, samples and render seconds."""

    rays_traced: float = 0.0
    samples: int = 0
    render_s: float = 0.0

    def rays_per_sec(self) -> float:
        return self.rays_traced / max(self.render_s, 1e-9)
