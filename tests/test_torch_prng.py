"""The port's threefry keys, uniforms and int draws are bit for bit
``jax.random``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro_torch import prng, utils

SEEDS = [0, 1, 7, 42, 1234, 2**31 - 1, 987654321]


def _same(jax_key, torch_key):
    np.testing.assert_array_equal(np.asarray(jax_key).astype(np.int64),
                                  torch_key.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same(jk, tk)
    for n in (1, 2, 3, 5, 17):
        _same(jax.random.split(jk, n), prng.split(tk, n))
    # A chain of splits, as the ingest advances the ring's lead key.
    for _ in range(4):
        jk, tk = jax.random.split(jk, 3)[0], prng.split(tk, 3)[0]
        _same(jk, tk)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_fold_in_str(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for d in (0, 1, 0xE717, 0xE31, 2**31 - 1, 2**32 - 1):
        _same(jax.random.fold_in(jk, d), prng.fold_in(tk, d))
    for label in ("total", "avg", "big", "p"):
        _same(jutils.fold_in_str(jk, label), utils.fold_in_str(tk, label))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m", [1, 2, 7, 128, 333, 1000])
def test_uniform_bitwise(seed, m):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for sub_j, sub_t in zip(jax.random.split(jk, 3), prng.split(tk, 3)):
        u = np.asarray(jax.random.uniform(sub_j, (m,)))
        t = prng.uniform(sub_t, m).numpy()
        np.testing.assert_array_equal(u.view(np.int32), t.view(np.int32))
        assert t.min() >= 0.0 and t.max() < 1.0


def test_uniform_multidimensional_and_bits():
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    u = np.asarray(jax.random.uniform(jk, (5, 7)))
    np.testing.assert_array_equal(
        u.view(np.int32), prng.uniform(tk, (5, 7)).numpy().view(np.int32))
    bits = np.asarray(jax.random.bits(jk, (9,), dtype=np.uint32))
    np.testing.assert_array_equal(bits.astype(np.int64),
                                  prng.random_bits(tk, 9).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed):
    """int32 draws with an array ``maxval``, as the bootstrap makes them
    (``maxval = max(taken, 1)[:, None]`` over ``[G, N]``), spans on both
    sides of 2**16 (where the reference's u32 multiplier wraps to 0)."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    taken = np.array([0, 1, 5, 100, 65535, 65536, 65537, 70000, 2**20,
                      1_000_003, 2**31 - 1], np.int32)
    hi = np.maximum(taken, 1)[:, None]
    a = jax.random.randint(jk, (11, 37), 0, jnp.asarray(hi))
    b = prng.randint(tk, (11, 37), 0, torch.from_numpy(hi))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert b.dtype == torch.int32


@pytest.mark.parametrize("lo,hi", [(0, 1), (-5, 3), (3, -5), (7, 7),
                                   (-2**31, 2**31 - 1), (0, 6)])
def test_randint_scalar_bounds(lo, hi):
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    a = jax.random.randint(jk, (257,), lo, hi)
    b = prng.randint(tk, 257, lo, hi)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
