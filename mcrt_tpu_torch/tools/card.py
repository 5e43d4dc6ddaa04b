"""The card's name and power limit, to print beside every time measured on
it (a card set below its maximum power runs slower under load), the time a
kernel takes on it, and the SM clock while a kernel runs.  ``nvidia-smi``
is asked about the card torch runs on (its current device), by UUID: its
own numbering ignores ``CUDA_VISIBLE_DEVICES``."""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

# About a millisecond at the H100's clocks: far longer than the host takes
# to enqueue one call of a kernel's wrapper (tens of microseconds).
SPIN_CYCLES = 2_000_000


def smi_id() -> str:
    """``nvidia-smi -i``'s name for torch's current CUDA device: its UUID."""
    uuid = str(torch.cuda.get_device_properties(torch.cuda.current_device()).uuid)
    return uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"


def card_line() -> str:
    """``name, power.limit`` of torch's current card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "-i", smi_id(), "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def sm_clock_during(fn, call_ms: float, seconds: float = 1.0):
    """(median MHz, every sample) of torch's current card's SM clock, which
    ``nvidia-smi`` reads every 50 ms while ``fn`` (a call of about
    ``call_ms`` on that card) runs back to back for about ``seconds``.  Two
    batches of calls are queued before the sampler starts and one stays
    queued until it is stopped, so every sample falls on a busy card."""
    per_batch = max(1, int(50.0 / max(call_ms, 1e-3)))

    def batch():
        for _ in range(per_batch):
            fn()
        done = torch.cuda.Event()
        done.record()
        return done

    pending = [batch(), batch()]
    proc = subprocess.Popen(["nvidia-smi", "-i", smi_id(), "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            pending.pop(0).synchronize()
            pending.append(batch())
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    torch.cuda.synchronize()
    samples = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    if not samples:
        raise RuntimeError("nvidia-smi gave no SM clock sample")
    return statistics.median(samples), samples
