"""The card's name and power limit, to print beside every time measured on
it (a card set below its maximum power runs slower under load), and the
time a kernel takes on it."""
from __future__ import annotations

import statistics
import subprocess

import torch

# About a millisecond at the H100's clocks: far longer than the host takes
# to enqueue one call of a kernel's wrapper (tens of microseconds).
SPIN_CYCLES = 2_000_000


def card_line() -> str:
    """``name, power.limit`` of the first card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_timed(fn, reps: int):
    """(median ms, every call's ms, last result) of ``reps`` calls of
    ``fn``, each timed on the card alone.  A CUDA event recorded on an idle
    card fires at once, so a window around one call would also hold the
    host's time in the wrapper before the launch (checks, allocation, the
    ctypes call), which is longer than a small kernel.  So each window is
    queued behind a spin on the card: by the time the spin ends, the host
    has enqueued the start event, the call's launches and the end event,
    and the window holds the card's time for the call alone."""
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times, out
