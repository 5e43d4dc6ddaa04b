"""Raw arithmetic throughput of the card: float32 and bfloat16 elementwise
chains and a small-K float32 matrix product, each repeated ``ITERS`` times
inside one kernel launch so that the launch cost is amortised.

    python -m mcrt_tpu_torch.tools.vpu_bench

It prints the card's name and power limit (as ``nvidia-smi`` reports them)
and four lines: ``chain float32`` and ``chain bfloat16`` (ms, Tops/s),
``matmul K=8`` and ``matmul K=128`` (ms, TF/s, Gout/s).  Operations are
counted as the JAX package's ``tools/vpu_bench.py`` counts them: 5 a round
of the chain, 2 a multiply-add of the product.

Kernels: K8 (``kernels.vpu_chain``) and K9 (``kernels.vpu_matmul``), in
``csrc/vpu.cu``.  ``run_chain`` and ``run_matmul`` launch them for CUDA
tensors and run the plain versions ``chain_plain`` / ``matmul_plain`` for
CPU tensors.  The output does not depend on ``iters``: every pass recomputes
the same result, as every grid step of the TPU kernels does.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..accel import kernels
from .card import card_line

M, N = 256, 1024
ITERS = 2000
ROUNDS = 20  # rounds of (multiply-add, min, abs-subtract) in one pass
MM_ROWS = 512
KS = (8, 128)
GENERIC_KS = (5, 33)  # more k for K9's generic path: under its k unroll of 32, and past it


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors (broadcast), rounded once to float32
    as a fused multiply-add rounds it.  The float64 product is exact; the
    float64 sum rounds once more, which can leave it on the midpoint of two
    float32 values, and there the sign of the sum's rounding error (from
    TwoSum) picks the float32 value a single rounding gives."""
    p, c64 = a.double() * b.double(), c.double()
    s = p + c64
    v = s - p
    err = (p - (s - v)) + (c64 - v)
    r = s.float()
    r64 = r.double()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    other = torch.nextafter(r, torch.where(r64 < s, inf, -inf))
    o64 = other.double()
    tie = (r64 + o64) == 2.0 * s
    return torch.where(tie & (err * (o64 - s) > 0), other, r)


def chain_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One pass of K8 on ``x`` cast to ``dtype``: float32 rounds each
    multiply-add once (``fma_f32``), as the JAX kernel's contracted
    ``acc * x + x`` does; bfloat16 rounds every operation on its own."""
    x = x.to(dtype)
    acc = x
    for _ in range(ROUNDS):
        acc = fma_f32(acc, x, x) if dtype == torch.float32 else acc * x + x
        acc = torch.minimum(acc, x)
        acc = acc.abs() - x
    return acc


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K9's product: k rank-1 updates in k order from +0, each a
    single-rounded float32 multiply-add."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for kk in range(a.shape[1]):
        out = fma_f32(a[:, kk:kk + 1], b[kk:kk + 1, :], out)
    return out


def run_chain(x: torch.Tensor, dtype: torch.dtype, iters: int = ITERS) -> torch.Tensor:
    """K8 on a CUDA tensor (``iters`` passes in one launch), the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return chain_plain(x, dtype)
    return kernels.vpu_chain(x.to(dtype).contiguous(), iters)


def run_matmul(a: torch.Tensor, b: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """K9 on CUDA tensors (``iters`` products in one launch), the plain
    version on CPU tensors."""
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    return kernels.vpu_matmul(a, b, iters)


def _normal(seed: int, shape, device) -> torch.Tensor:
    arr = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(arr).to(device)


def chain_input(device) -> torch.Tensor:
    """The JAX tool's chain input: x (M, N) float32, standard normal, seed 0."""
    return _normal(0, (M, N), device)


def matmul_inputs(device, k: int):
    """The JAX tool's product inputs: a (512, k) from seed 1 and b (k, N)
    from seed 2, float32, standard normal."""
    return _normal(1, (MM_ROWS, k), device), _normal(2, (k, N), device)


def _ms_of_one_call(fn) -> float:
    """Milliseconds of one call after one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("vpu_bench: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    x = chain_input(device)
    for dtype in (torch.float32, torch.bfloat16):
        ms = _ms_of_one_call(lambda: run_chain(x, dtype))
        ops = ITERS * ROUNDS * 5 * M * N
        print(f"chain {str(dtype).split('.')[-1]}: {ms:8.2f} ms  "
              f"{ops / (ms / 1e3) / 1e12:6.2f} Tops/s")
    for k in KS:
        a, b = matmul_inputs(device, k)
        ms = _ms_of_one_call(lambda: run_matmul(a, b))
        dt = ms / 1e3
        fl = ITERS * 2 * MM_ROWS * k * N
        print(f"matmul K={k:4d}: {ms:8.2f} ms  {fl / dt / 1e12:6.2f} TF/s "
              f"({ITERS * MM_ROWS * N / dt / 1e9:5.1f} Gout/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
