"""The ray queries' share of their roofline, in %: the least time the
queries could take, their bytes over the H100's 3.35 TB/s HBM peak
(``stats.query_bytes``: each live ray's origin, direction and extent read
once, its result written once, every triangle read once a query), over
the device time of the ops inside the query spans.  It counts no
operations, so it reads the same work whatever implements the query."""
from perfbench import stats

SPANS = ("perfbench.query.intersect", "perfbench.query.occluded")


def read(rec):
    dev_us = sum(d for s in SPANS for _, _, d in rec.spans.get(s, []))
    if dev_us <= 0 or "query_bytes" not in rec.counters:
        return None
    return 100.0 * (rec.counters["query_bytes"] / stats.HBM_BYTES_PER_S) / (dev_us / 1e6)
