"""The window's arithmetic: rates over the whole window, percentiles over
every sample, the union of device intervals, idle gaps, and the query
byte floor.  Plain Python, no device: the tests hold it by hand."""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, HBM3
RAY_BYTES = 32  # origin and direction (2 x 3 float32), tmin and tmax (2 float32)
CLOSEST_RESULT_BYTES = 8  # t (float32) and primitive (int32)
OCCLUDED_RESULT_BYTES = 1  # one flag
TRIANGLE_BYTES = 36  # three float32 vertices


def per_item_ms(wall_s: float, items: int) -> float:
    """Milliseconds a unit of work over the whole window: its wall time
    over every item completed in it."""
    if items <= 0:
        raise ValueError("the window completed no work")
    return wall_s * 1e3 / items


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value (``q`` in
    (0, 100]): the least value with at least q% of the values at or below
    it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


def merge_intervals(intervals):
    """Sorted, disjoint (start, end) intervals covering the given ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals: time covered by at
    least one, overlaps counted once."""
    return sum(e - s for s, e in merge_intervals(intervals))


def idle_share(intervals, window: float) -> float:
    """1 - (union of device intervals) / window."""
    if window <= 0:
        raise ValueError("empty window")
    return 1.0 - union_length(intervals) / window


def gaps(intervals, lo: float, hi: float):
    """Idle (start, end) gaps between the merged intervals inside [lo, hi]."""
    out, cur = [], lo
    for s, e in merge_intervals(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def query_bytes(closest_live, occluded_live, queries: int, triangles: int) -> int:
    """The least bytes a set of ray queries moves: each live ray's origin,
    direction and extent read once, its result written once (t and the
    primitive for a closest hit, a flag for an occlusion query), and every
    triangle of the scene read once a query."""
    return (int(closest_live) * (RAY_BYTES + CLOSEST_RESULT_BYTES)
            + int(occluded_live) * (RAY_BYTES + OCCLUDED_RESULT_BYTES)
            + int(queries) * int(triangles) * TRIANGLE_BYTES)
