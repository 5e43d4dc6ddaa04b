"""The traced run's record: ``torch.profiler`` (CUPTI) over a window, read
back from its Chrome trace into device intervals, kernels, the
benchmark's own spans and the host ops, which the per-layer metric readers
(``metrics/``) take their numbers from."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

from . import stats

WINDOW_SPAN = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Record:
    """What one traced window saw.  Times are microseconds on the trace's
    clock; ``window_s`` is the host clock's window, ended by a sync."""

    loop: str
    window_s: float = 0.0
    samples: int = 0  # samples per pixel (or steps) completed in the window
    device: list = field(default_factory=list)  # (name, ts, dur) of every device op
    kernels: list = field(default_factory=list)  # (name, ts, dur), kernels alone
    spans: dict = field(default_factory=dict)  # name -> [(ts, dur, device_us)]
    host: list = field(default_factory=list)  # (name, ts, dur) host ops
    counters: dict = field(default_factory=dict)
    window: tuple = (0.0, 0.0)  # the window span on the trace's clock
    # the host-clock seconds the traced work takes with no profiler: the
    # window's untraced work, scaled to the traced count (0: there was none)
    untraced_s: float = 0.0

    @property
    def busy_s(self) -> float:
        return stats.union_length([(ts, ts + d) for _, ts, d in self.device]) / 1e6


class Traced:
    """``fn()`` (which returns the samples it completed) run under the
    profiler, between two syncs.  The trace is read by ``record()``, which
    a loop calls once its window has closed, so reading it takes no time
    from the window."""

    def __init__(self, fn, loop: str, sync):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.loop = loop
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            with record_function(WINDOW_SPAN):
                t0 = time.perf_counter()
                self.samples = fn()
                sync()
                self.window_s = time.perf_counter() - t0
        self._prof = prof

    def record(self) -> Record:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        rec = parse(events, self.loop)
        rec.window_s, rec.samples = self.window_s, self.samples
        return rec


def untraced_s(traced: int, rest_s: float, rest: int) -> float:
    """The seconds ``traced`` items take untraced, from ``rest`` untraced
    items that took ``rest_s``; 0 where there were none."""
    return traced * rest_s / rest if rest > 0 else 0.0


def parse(events, loop: str) -> Record:
    """A ``Record`` from Chrome-trace events (complete events only)."""
    rec = Record(loop=loop)
    runtime = []  # (ts, correlation) of launches
    by_corr = {}
    spans = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            rec.device.append((name, ts, dur))
            if cat == "kernel":
                rec.kernels.append((name, ts, dur))
            if "correlation" in args:
                by_corr[args["correlation"]] = by_corr.get(args["correlation"], 0.0) + dur
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                runtime.append((ts, args["correlation"]))
        elif cat in HOST_CATS:
            if name == WINDOW_SPAN:
                rec.window = (ts, ts + dur)
            elif cat == "user_annotation" and name.startswith("perfbench."):
                spans[name].append((ts, dur))
            rec.host.append((name, ts, dur))
    runtime.sort()
    starts = [r[0] for r in runtime]
    for name, items in spans.items():
        out = []
        for ts, dur in items:
            lo, hi = bisect.bisect_left(starts, ts), bisect.bisect_right(starts, ts + dur)
            out.append((ts, dur, sum(by_corr.get(runtime[i][1], 0.0) for i in range(lo, hi))))
        rec.spans[name] = out
    return rec


def top_device_ops(rec: Record, n: int = 10):
    """[[name, seconds]] of the device ops with the most time, by name."""
    tot = defaultdict(float)
    for name, _, dur in rec.device:
        tot[name[:160]] += dur / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host_op(rec: Record, n: int = 10):
    """[[host op, seconds]]: the window's device idle time, each gap named
    by the innermost host op running at its start ("python" where none
    was), summed by name, the largest first."""
    lo, hi = rec.window
    host = sorted((ts, ts + dur, name) for name, ts, dur in rec.host if name != WINDOW_SPAN)
    starts = [h[0] for h in host]
    tot = defaultdict(float)
    for s, e in stats.gaps([(ts, ts + d) for _, ts, d in rec.device], lo, hi):
        i = bisect.bisect_right(starts, s)
        best = None
        for j in range(i - 1, max(-1, i - 65), -1):
            hs, he, name = host[j]
            if hs <= s < he and (best is None or he - hs < best[0]):
                best = (he - hs, name)
        tot[best[1] if best else "python"] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
