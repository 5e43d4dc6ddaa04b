"""Device milliseconds of BDPT's shadow-ray queries a sample per pixel: the
time of the device ops launched inside the benchmark's
``perfbench.query.occluded`` spans over the samples the traced window
completed (queries layer).  Under BDPT every occlusion query is a chunk
of the staged shadow rays (every strategy's, live or not, at most 2^21 a
query), so this is the chunked occlusion that compacting the staged rays
to the live ones would cut."""


def read(rec):
    items = rec.spans.get("perfbench.query.occluded", [])
    if not items or not rec.samples:
        return None
    return sum(dev_us for _, _, dev_us in items) / 1e3 / rec.samples
