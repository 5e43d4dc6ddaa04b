"""Device milliseconds of the ray queries a sample per pixel: the time of
the device ops launched inside the benchmark's ``perfbench.query.*``
spans (around ``Intersector.intersect`` and ``.occluded``) over the
samples the traced window completed."""

SPANS = ("perfbench.query.intersect", "perfbench.query.occluded")


def read(rec):
    items = [x for s in SPANS for x in rec.spans.get(s, [])]
    if not items or not rec.samples:
        return None
    return sum(dev_us for _, _, dev_us in items) / 1e3 / rec.samples
