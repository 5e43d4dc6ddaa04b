"""Rank 0's share of rendering spent in collective kernels, in %: the
device time of its NCCL kernels in the traced batches over the wall time
the same batches take untraced (distribution layer)."""


def read(rec):
    if rec.loop != "sharded" or rec.untraced_s <= 0 or not rec.kernels:
        return None
    nccl = sum(d for name, _, d in rec.kernels if "nccl" in name.lower())
    return 100.0 * nccl / (rec.untraced_s * 1e6)
