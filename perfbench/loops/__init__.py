"""The loops that drive a window, one module each, named by a traffic
mix's ``"loop"``.  Each module's ``run(ctx)`` returns an ``Outcome``."""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Outcome:
    end_to_end: dict  # metric name -> value (the untraced run's)
    values: dict  # compared number name -> value
    attempted: int
    failed: int = 0
    record: object = None  # trace.Record of a traced run
    memory_peak_bytes: int = 0
    notes: dict = field(default_factory=dict)  # diagnostics for standard error


def first_frame(seed: int, traffic: dict) -> int:
    """The sample index the window starts at: ``2 ** (base + seed % span)``.
    One set bit, so every seed's frames have the same bit counts (the Sobol
    fold launches one op per set bit) and the same work."""
    return 1 << (int(traffic["first_frame_log2"]) + int(seed) % int(traffic["first_frame_span"]))


def trace_start(done: int, items: int, f0: int, per: int) -> int:
    """How many untraced items (frames or batches of ``per`` samples, a
    power of two) a traced run's window runs before it traces ``items``
    more: the least power of two at or above ``done`` and ``items`` whose
    samples do not end at ``f0``.  The traced samples' indices then have the
    same set bits in every run, so the launches counted in them do not move
    with the number of frames the window held."""
    p = 1
    while p < max(done, items) or p * per == f0:
        p *= 2
    return p


def sync(dev):
    """Wait for the device (a no-op on the CPU, where the tests run)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Mark:
    """A point in a device's stream: a CUDA event on the card, the host
    clock on the CPU."""

    def __init__(self, dev):
        import torch

        if dev.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.event, self.t = None, time.perf_counter()

    def ms_to(self, later: "Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return (later.t - self.t) * 1e3


def peak_bytes(dev) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
