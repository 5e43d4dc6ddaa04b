"""Profiling spans and renderer metrics (counterpart of
``mcrt_tpu/utils/profiling.py``).

- program spans: ``span(name)`` is a ``torch.profiler.record_function``
  range while a profiler records, and a shared no-op context otherwise, so
  the main path's ``mcrt.*`` spans cost one flag test when no one traces.
  They open no device op and make no host sync, so a frame launches the
  same work with tracing on or off;
- the live-ray counter: ``tally(name, mask)`` keeps a query's ``active``
  mask while a profiler records, and ``tallies()`` sums them (one sync);
- host counts: ``count(name, value)`` keeps a host integer while a profiler
  records, the last one set a name (BDPT's staged shadow rays and chunk
  queries of the last traced frame), and ``counts()`` reads them;
- host spans: a registry of named, nested spans with per-span count, last,
  average and maximum times and a bounded history (``Profiler``, and the
  module-level ``profiler``), each also a ``span`` range;
- device time: ``Profiler.span(..., sync=tensor)`` waits for the tensor's
  card (``torch.cuda.synchronize``, the counterpart of
  ``jax.block_until_ready``);
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
from torch.autograd import profiler as _autograd_profiler

_IDLE = contextlib.nullcontext()
# masks kept a name before they are folded into one device count: bounds
# what a long recording holds (a 512x512 frame hands 8 masks of 256 KiB a
# name, so 32 frames)
_FOLD = 256
_tallies: dict[str, list] = {}
_counts: dict[str, int] = {}


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records, else one shared ``contextlib.nullcontext()``: tracing is on
    exactly while someone records a trace."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _IDLE


def tally(name: str, mask: torch.Tensor):
    """While a profiler records, keep a reference to ``mask`` (a bool
    tensor of live lanes) under ``name``; launches nothing.  Outside a
    recording nothing is kept: the first tally after one drops what
    ``tallies()`` did not read, so read it before the next query."""
    if _autograd_profiler._is_profiler_enabled:
        kept = _tallies.setdefault(name, [])
        kept.append(mask)
        if len(kept) >= _FOLD:
            kept[:] = [torch.stack([m.sum() for m in kept]).sum()]
    elif _tallies:
        _tallies.clear()


def tallies() -> dict[str, int]:
    """``{name: the true lanes of every mask tallied under it}``, read with
    one sync; the tallies are cleared."""
    names = list(_tallies)
    if not names:
        return {}
    sums = torch.stack([torch.stack([m.sum() for m in _tallies[k]]).sum() for k in names])
    _tallies.clear()
    return dict(zip(names, (int(v) for v in sums.tolist())))


def count(name: str, value: int):
    """While a profiler records, keep the host integer ``value`` under
    ``name``, replacing the one kept before; launches nothing and reads
    nothing from a device."""
    if _autograd_profiler._is_profiler_enabled:
        _counts[name] = int(value)


def counts() -> dict[str, int]:
    """``{name: the last value counted under it}``; cleared once read."""
    out = dict(_counts)
    _counts.clear()
    return out


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
        """Time a host-side span, a ``span(name)`` range in a trace.  Card
        work is asynchronous: without ``sync`` the span times only the
        queuing of its work; with a tensor on a card, the span ends when
        that card has finished its work."""
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with span(name):
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
