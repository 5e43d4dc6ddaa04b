"""GiB of the storages autograd saves for one gradient step's backward,
each counted once, taken with ``saved_tensors_hooks`` after the traced
window (gradients layer): the graph that a step holds until its backward,
most of its peak memory."""


def read(rec):
    return rec.counters["saved_bytes"] / 2**30 if "saved_bytes" in rec.counters else None
