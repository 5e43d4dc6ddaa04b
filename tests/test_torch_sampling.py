"""Sample streams of the PyTorch port against the JAX package.

Both samplers are held bit-equal.  SOBOL: the same direction numbers, XOR
fold and per-pixel digit scramble.  RANDOM: the same threefry key folded
over (seed, frame, dimension), counters and float conversion as
``jax.random.uniform``.  The port does its uint32 arithmetic in int64.
RANDOM is also checked by distribution: mean and variance of a uniform on
[0, 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrt_tpu.config import SamplerConfig as JSamplerConfig
from mcrt_tpu.config import SamplerType as JSamplerType
from mcrt_tpu.sampling import rng as jrng
from mcrt_tpu.sampling import sobol as jsobol
from mcrt_tpu_torch.config import SamplerConfig, SamplerType
from mcrt_tpu_torch.sampling import rng as trng
from mcrt_tpu_torch.sampling import sobol as tsobol

# The tier-1 run spreads test files over several worker processes on a few
# cores: one torch thread per process keeps OpenMP from oversubscribing
# them (measured 20x slower runs otherwise).
torch.set_num_threads(1)

N_PIXELS, N_DIMS, FRAMES = 256, 64, (0, 1, 5, 1023)


def _pixels():
    rng = np.random.default_rng(77)
    ids = rng.integers(0, 2**31 - 1, N_PIXELS, dtype=np.int64).astype(np.int32)
    ids[:4] = (0, 1, 2, 2**31 - 1)
    return ids


def test_sobol_matrices_equal():
    np.testing.assert_array_equal(tsobol.sobol_matrices(device="cpu").numpy(),
                                  np.asarray(jsobol.sobol_matrices()).astype(np.int64))


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("seed", [0, 12345])
def test_sobol_samples_bit_equal(frame, seed):
    pixels = _pixels()
    dims = np.arange(N_DIMS, dtype=np.int32)
    scramble = seed * 2654435761 % (1 << 32)
    j = np.asarray(jsobol.sobol_sample_scrambled(
        jsobol.sobol_matrices(), jnp.asarray(frame, jnp.int32), jnp.asarray(dims),
        jnp.asarray(pixels), jnp.asarray(np.uint32(scramble))))
    t = tsobol.sobol_sample_scrambled(
        tsobol.sobol_matrices(device="cpu"), frame,
        torch.from_numpy(dims.astype(np.int64)), torch.from_numpy(pixels), scramble).numpy()
    assert t.shape == j.shape == (N_PIXELS, N_DIMS)
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


def _per_bit_fold(mats: torch.Tensor, index: int, dims: torch.Tensor) -> torch.Tensor:
    """The fold as the port drew it before the per-frame table: one XOR of
    a dimension's direction number a set bit of the index, on the device."""
    d_mats = mats[dims.clamp(0, mats.shape[0] - 1)]
    x = torch.zeros(dims.shape, dtype=torch.int64)
    for b in range(32):
        if (index >> b) & 1:
            x = x ^ d_mats[:, b]
    return x


_FOLD_INDICES = ([0, 1] + [2**k for k in range(1, 32)] + [2**32 - 1]
                 + np.random.default_rng(20).integers(0, 2**32, 4).tolist())


@pytest.mark.parametrize("index", _FOLD_INDICES)
def test_fold_table_draws_equal_per_bit_fold_and_jax(index):
    """Sample ``index``'s fold table (taken on the host once a stream) over
    dimensions 0-255 equals the per-bit fold, and the draws gathered from
    it equal the JAX package's, bit for bit: a stream's three draws against
    ``jax``'s at dimension 0, and every dimension at once through
    ``sobol_sample_scrambled``."""
    pixels = _pixels()[:16]
    mats = tsobol.sobol_matrices(device="cpu")
    dims = torch.arange(256)
    table = tsobol.fold_table(index, "cpu")
    assert table.shape == (256,) and table.dtype == torch.int64
    assert torch.equal(table, _per_bit_fold(mats, index, dims))
    scramble = 12345 * 2654435761 % (1 << 32)
    j = np.asarray(jsobol.sobol_sample_scrambled(
        jsobol.sobol_matrices(), jnp.asarray(np.uint32(index)),
        jnp.asarray(dims.numpy(), jnp.int32), jnp.asarray(pixels),
        jnp.asarray(np.uint32(scramble))))
    t = tsobol.sobol_scrambled(table, dims, torch.from_numpy(pixels), scramble).numpy()
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))
    ts = trng.make_stream(SamplerConfig(type=SamplerType.SOBOL, seed=12345), index,
                          torch.from_numpy(pixels))
    assert torch.equal(ts.sobol_fold, table)
    for k, draw in ((0, trng.next_1d), (1, trng.next_2d), (3, trng.next_3d)):
        u, ts = draw(ts)
        u = u.reshape(len(pixels), -1).numpy()
        np.testing.assert_array_equal(u.view(np.int32), j[:, k:k + u.shape[1]].view(np.int32))


@pytest.mark.parametrize("frame", FRAMES)
def test_sobol_stream_draws_bit_equal(frame):
    """The 1D/2D/3D draw sequence of one bounce, twice over."""
    pixels = _pixels()
    js = jrng.make_stream(JSamplerConfig(type=JSamplerType.SOBOL, seed=3),
                          jnp.asarray(frame, jnp.int32), jnp.asarray(pixels))
    ts = trng.make_stream(SamplerConfig(type=SamplerType.SOBOL, seed=3), frame,
                          torch.from_numpy(pixels))
    for _ in range(2):
        for jdraw, tdraw in ((jrng.next_1d, trng.next_1d), (jrng.next_2d, trng.next_2d),
                             (jrng.next_3d, trng.next_3d)):
            ju, js = jdraw(js)
            tu, ts = tdraw(ts)
            np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                          np.asarray(ju).view(np.int32))
    assert ts.dim == int(js.dim) == 12


@pytest.mark.parametrize("seed, frame, dim, n, draw", [
    (0, 0, 0, 5, "next_2d"),
    (9, 4, 7, 1000, "next_3d"),
    (12345, 70000, 3, 77, "next_1d"),
    (3, 1, 65541, 300, "next_3d"),
    (2**31 - 1, 2**31 - 1, 2**31 - 10, 64, "next_2d"),
])
def test_random_streams_bit_equal_to_jax(seed, frame, dim, n, draw):
    """RANDOM draws at a given (seed, frame, dimension), frames and
    dimensions past 2^16 among them, then the next draw of each kind."""
    pixels = _pixels()[:n] if n <= N_PIXELS else np.arange(n, dtype=np.int32)
    js = jrng.make_stream(JSamplerConfig(seed=seed), jnp.asarray(frame, jnp.int32),
                          jnp.asarray(pixels))
    js = js.replace(dim=jnp.asarray(dim, jnp.int32))
    ts = trng.make_stream(SamplerConfig(seed=seed), frame, torch.from_numpy(pixels))
    ts = ts.advance(dim)
    assert ts.kind == js.kind == 0
    for name in (draw, "next_1d", "next_2d", "next_3d"):
        ju, js = getattr(jrng, name)(js)
        tu, ts = getattr(trng, name)(ts)
        assert tu.shape == ju.shape and tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy().view(np.int32), np.asarray(ju).view(np.int32))
    assert ts.dim == int(js.dim)


def test_random_stream_distribution():
    """RANDOM: uniforms in [0, 1) with mean 1/2 and variance 1/12 on both
    sides (4 sigma of the sample mean over 65,536 pixels x 3 dims),
    deterministic per (seed, frame, dimension) and different across them."""
    n = 1 << 16
    pixels = np.arange(n, dtype=np.int32)
    js = jrng.make_stream(JSamplerConfig(seed=9), jnp.asarray(4, jnp.int32),
                          jnp.asarray(pixels))
    ts = trng.make_stream(SamplerConfig(seed=9), 4, torch.from_numpy(pixels))
    ju, _ = jrng.next_3d(js)
    tu, ts2 = trng.next_3d(ts)
    tol = 4.0 * np.sqrt(1.0 / 12.0 / (3 * n))
    for u in (np.asarray(ju), tu.numpy()):
        assert u.shape == (n, 3) and u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < tol
        assert abs(u.var() - 1.0 / 12.0) < 2e-3
    again, _ = trng.next_3d(ts)
    np.testing.assert_array_equal(again.numpy(), tu.numpy())
    nxt, _ = trng.next_3d(ts2)
    other_frame, _ = trng.next_3d(trng.make_stream(SamplerConfig(seed=9), 5,
                                                   torch.from_numpy(pixels)))
    assert not np.array_equal(nxt.numpy(), tu.numpy())
    assert not np.array_equal(other_frame.numpy(), tu.numpy())
    # independent dimensions: no correlation between consecutive draws
    corr = np.corrcoef(tu.numpy()[:, 0], nxt.numpy()[:, 0])[0, 1]
    assert abs(corr) < 4.0 / np.sqrt(n)


@pytest.mark.parametrize("entry", ["make_stream", "sobol_sample_scrambled"])
def test_draws_take_the_shipped_direction_numbers_only(entry):
    """Both entries that take direction numbers accept the shipped ones and
    refuse others (an equal copy among them): the fold is taken from the
    shipped numbers' host copy, and a caller's own on a card would have to
    be read back, a host sync."""
    pixels, dims = torch.arange(8), torch.arange(4)
    shipped = tsobol.sobol_matrices(device="cpu")
    cfg = SamplerConfig(type=SamplerType.SOBOL, seed=3)

    def draw(mats):
        if entry == "make_stream":
            return trng.next_3d(trng.make_stream(cfg, 5, pixels, sobol_mats=mats))[0]
        return tsobol.sobol_sample_scrambled(mats, 5, dims, pixels, 3)

    assert torch.isfinite(draw(shipped)).all()
    with pytest.raises(ValueError, match="shipped direction numbers"):
        draw(shipped.clone())
