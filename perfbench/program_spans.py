"""The program's own spans in a traced run's record: the ``mcrt.*`` ranges
that ``mcrt_tpu_torch`` opens while a profiler records, one for each stage
of a frame (``mcrt.frame``, ``mcrt.camera``, ``mcrt.query.*``,
``mcrt.shade`` and its parts, ``mcrt.film``, ``mcrt.dist.*``, ...).  They
arrive in ``Record.host`` as ``(name, ts, dur)`` on the device trace's
clock, beside the host ops.

Plain Python over the record, importing nothing of the program:

- ``Spans``: the ``mcrt.*`` spans sorted by start, each with the span that
  encloses it, so ``Spans.at(t)`` finds the innermost one open at ``t`` by
  a binary search and a walk up its parents, however many host events lie
  between;
- ``ops_per_spp``: the top-level host ops (enclosed by no other host op)
  that start inside a stage's spans, over the samples;
- ``idle_share``: the device's idle share of rendering (as
  ``device.idle_share.render`` reads it) apportioned by where the host was
  at the start of each traced idle gap, so the stages' shares sum to it.

A stage is a span name and its children: ``mcrt.shade`` takes
``mcrt.shade.nee``; ``mcrt.query`` takes every ``mcrt.query.*``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from . import stats

PREFIX = "mcrt."
UNSPANNED = "unspanned"  # an idle gap that starts inside no ``mcrt.*`` span
# ranges in ``Record.host`` that are spans, not ops: the program's and the
# benchmark's own (``perfbench.window``, ``perfbench.query.*``)
SPAN_PREFIXES = (PREFIX, "perfbench.")
RENDER_LOOPS = ("progressive", "sharded")


class Spans:
    """The ``mcrt.*`` spans of ``host`` events, for finding the innermost
    one open at a time.  Spans of one thread nest, so of the spans open at
    ``t`` the innermost is the one that started last."""

    def __init__(self, host):
        self.items = sorted(((ts, ts + dur, name) for name, ts, dur in host
                             if name.startswith(PREFIX)), key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.items]
        self.parent = []
        open_ = []
        for i, (s, _, _) in enumerate(self.items):
            while open_ and self.items[open_[-1]][1] <= s:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def __bool__(self) -> bool:
        return bool(self.items)

    def at(self, t: float):
        """The name of the innermost span with start <= t < end, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            _, end, name = self.items[i]
            if t < end:
                return name
            i = self.parent[i]
        return None


def in_stage(name, stage: str) -> bool:
    """Whether span ``name`` is ``stage`` or one of its children."""
    return name is not None and (name == stage or name.startswith(stage + "."))


def top_level_ops(host) -> list:
    """Start times of the host ops that no other host op encloses (the
    spans are not ops): one a dispatch from the program's Python."""
    ops = sorted(((ts, ts + dur) for name, ts, dur in host
                  if not name.startswith(SPAN_PREFIXES)), key=lambda x: (x[0], -x[1]))
    out, end = [], float("-inf")
    for s, e in ops:
        if s >= end:
            out.append(s)
            end = e
    return out


def ops_per_spp(rec, stage: str):
    """Top-level host ops starting inside ``stage``'s spans, a sample; None
    without ``mcrt.*`` spans or outside a rendering loop."""
    spans = Spans(rec.host)
    if rec.loop not in RENDER_LOOPS or not rec.samples or not spans:
        return None
    return sum(in_stage(spans.at(t), stage) for t in top_level_ops(rec.host)) / rec.samples


def idle_by_span(rec, spans: Spans) -> dict:
    """{innermost ``mcrt.*`` span at a gap's start, or ``UNSPANNED``: traced
    idle us}: every idle gap of the device in the traced window."""
    out = defaultdict(float)
    for s, e in stats.gaps([(ts, ts + d) for _, ts, d in rec.device], *rec.window):
        out[spans.at(s) or UNSPANNED] += e - s
    return dict(out)


def idle_share(rec, stage: str):
    """The device's idle share of rendering (%, ``device.idle_share.render``'s
    arithmetic) times the share of the traced idle time whose gaps start
    inside ``stage`` (``UNSPANNED``: inside no span).  The profiler slows
    the host, so traced gap seconds do not compare with the untraced wall
    time; apportioning by them keeps every stage's share summing to the
    render share.  A window that ran no device op (on the CPU) is one gap.
    None without ``mcrt.*`` spans or an untraced time to divide by."""
    spans = Spans(rec.host)
    if rec.loop not in RENDER_LOOPS or rec.untraced_s <= 0 or not spans:
        return None
    render = 100.0 * stats.idle_share([(ts, ts + d) for _, ts, d in rec.device],
                                      rec.untraced_s * 1e6)
    by = idle_by_span(rec, spans)
    total = sum(by.values())
    if total <= 0:
        return 0.0
    part = by.get(UNSPANNED, 0.0) if stage == UNSPANNED else sum(
        v for k, v in by.items() if in_stage(k, stage))
    return render * part / total
