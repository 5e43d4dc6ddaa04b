"""The port's card micro-benchmark (``mcrt_tpu_torch/tools/vpu_bench.py``,
the plain versions of kernels K8/K9) against the JAX package's
``tools/vpu_bench.py``.

The JAX tool is imported from its path under a private module name, with
that module object's ``ITERS`` set to 2 (the output does not depend on it:
every grid step recomputes the same block), and run in Pallas interpret
mode.  Tolerances: the chains are bit-equal in float32 (JAX contracts
``acc * x + x`` into one rounding, as ``fma_f32`` rounds) and in bfloat16
(every operation rounds on its own in both); the products agree within the
dot-product bound ``2 * k * 2**-24 * (|a| @ |b|)`` elementwise.
"""
import importlib.util
import os
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcrt_tpu_torch.tools import vpu_bench as tvb

# one torch thread per test process (see test_torch_blocked.py)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jvb():
    spec = importlib.util.spec_from_file_location(
        "_jax_vpu_bench", os.path.join(REPO, "tools", "vpu_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ITERS = 2
    return mod


def _bits(t: torch.Tensor) -> np.ndarray:
    view = torch.int32 if t.dtype == torch.float32 else torch.int16
    return t.view(view).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_plain_equals_jax(jvb, dtype):
    x = tvb.chain_input("cpu")
    assert x.shape == (jvb.M, jvb.N) == (tvb.M, tvb.N)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jvb.run_chain(jnp.asarray(x.numpy()), getattr(jnp, dtype)))
    out = tvb.run_chain(x, getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype)
    assert bool(torch.isfinite(out.float()).all())
    ref_bits = ref.view(np.int32 if dtype == "float32" else np.int16)
    np.testing.assert_array_equal(_bits(out), ref_bits)


@pytest.mark.parametrize("k", tvb.KS)
def test_matmul_plain_within_dot_bound_of_jax(jvb, k):
    a, b = tvb.matmul_inputs("cpu", k)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jvb.run_matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), k))
    out = tvb.run_matmul(a, b).numpy()
    assert out.shape == ref.shape == (512, 1024)
    tol = 2 * k * 2.0**-24 * (np.abs(a.numpy()).astype(np.float64)
                              @ np.abs(b.numpy()).astype(np.float64))
    assert (np.abs(out.astype(np.float64) - ref) <= tol).all()
    exact = a.numpy().astype(np.float64) @ b.numpy().astype(np.float64)
    assert (np.abs(out - exact) <= tol).all()


def test_plain_outputs_do_not_depend_on_iters():
    x = tvb.chain_input("cpu")[:8]
    a, b = tvb.matmul_inputs("cpu", 8)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(tvb.run_chain(x, dtype, iters=1), tvb.run_chain(x, dtype, iters=3))
    assert torch.equal(tvb.run_matmul(a, b, iters=1), tvb.run_matmul(a, b, iters=3))


def _fma_exact(a: float, b: float, c: float) -> np.float32:
    """Round the exact a * b + c to float32 (round to nearest, ties to even)."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(v))  # float64 rounding first: correct it below
    for cand in (np.nextafter(lo, np.float32(-np.inf)), np.nextafter(lo, np.float32(np.inf))):
        d_c, d_l = abs(Fraction(float(cand)) - v), abs(Fraction(float(lo)) - v)
        if d_c < d_l or (d_c == d_l and int(cand.view(np.int32)) % 2 == 0):
            lo = cand
    return lo


def test_fma_f32_rounds_once():
    """Where the float64 sum lands on a float32 midpoint, a second
    rounding would go the wrong way; ``fma_f32`` must not."""
    one, e = np.float32(1.0), np.float32(2.0**-23)
    a = [one + e, one + e]
    b = [np.float32(2.0**-24) * (one - e), np.float32(2.0**-24) * (one + e)]
    c = [one + e, one + e]
    rng = np.random.default_rng(7)
    a += list(rng.standard_normal(300).astype(np.float32))
    b += list(rng.standard_normal(300).astype(np.float32))
    c += list((rng.standard_normal(300) * 10.0 ** rng.integers(-3, 4, 300)).astype(np.float32))
    a, b, c = (np.array(v, np.float32) for v in (a, b, c))
    got = tvb.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert twice[0] != want[0]  # the case a float64 sum cast once more gets wrong


def test_vpu_bench_needs_a_card():
    """The micro-benchmark refuses to run, with code 2, where there is no
    CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run in full")
    assert tvb.main([]) == 2
