"""How fast one SM of the card issues FFMA (K9's instruction) and K8's whole
rounds (the micro-benchmark kernels of ``csrc/vpu.cu``) when nothing waits
on a dependence: the yardstick of their issue floors.

    python -m mcrt_tpu_torch.tools.issue_rates

Builds ``issue_rates.cu`` (a stand-alone CUDA program, no PyTorch) with the
kernel library's flags into ``mcrt_tpu_torch/_build/`` and runs it; prints
the card's name and power limit, then one line a probe: lane-operations a
clock on one SM (median over SMs), the warps an SM ran, the latency of one
operation in clocks, and the SM clock the probe's cycles imply.

``floor_ms`` turns a count of a probe's applies (an instruction, or one
of K8's rounds) into the least time the card takes to issue them at the
probe's measured rate and a given SM clock.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

from ..accel import kernels

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "issue_rates.cu")


def build() -> str:
    """The probe's executable, built once per source hash."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(kernels.NVCC_FLAGS).encode()).hexdigest()
    exe = os.path.join(kernels.BUILD_DIR, f"issue_rates_{digest[:16]}")
    if not os.path.exists(exe):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        tmp = f"{exe}.{os.getpid()}.tmp"
        flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        r = subprocess.run([kernels._nvcc(), *flags, "-o", tmp, SOURCE], capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, exe)
    return exe


def measure() -> dict:
    """{"sms": n, "probes": {name: {"ops", "lanes_per_clk_sm", "warps_per_sm",
    "latency_clk", "mhz"}}} from one run of the probe on the first visible
    card; the probes are ``ffma``, ``round_f32`` and ``round_bf16``."""
    r = subprocess.run([build()], capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"issue_rates probe failed ({r.returncode}): {r.stderr}")
    return json.loads(r.stdout)


def floor_ms(applies: float, probe: dict, sms: int, mhz: float) -> float:
    """Milliseconds to issue ``applies`` lane-applies of ``probe`` (one of
    ``measure()``'s probes: its rate counts ``ops`` operations an apply) on
    ``sms`` SMs at an SM clock of ``mhz``."""
    per_clk = probe["lanes_per_clk_sm"] / probe["ops"]
    return applies / (per_clk * sms * mhz * 1e6) * 1e3


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("issue_rates: needs a CUDA device", file=sys.stderr)
        return 2
    from .card import card_line

    print(f"card: {card_line()}")
    rates = measure()
    print(f"{rates['sms']} SMs")
    for name, p in rates["probes"].items():
        print(f"{name:16s} {p['lanes_per_clk_sm']:8.2f} lanes/clk/SM ({p['ops']} ops an "
              f"apply, {p['warps_per_sm']} warps/SM), latency {p['latency_clk']:.2f} clk, "
              f"SM clock {p['mhz']:.0f} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
