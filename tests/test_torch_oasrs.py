"""The port's OASRS chunk fold is bitwise the reference's ``update_chunk``
(values, counts and the advanced key), chunk after chunk."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oasrs as joasrs
from repro_torch import prng, utils
from repro_torch.core import distributed as tdist
from repro_torch.core import oasrs

SPEC = jax.ShapeDtypeStruct((), jnp.float32)
_jax_update = jax.jit(joasrs.update_chunk, static_argnames="backend")


def _chunks(seed, n, m, s):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.integers(0, s, m).astype(np.int32),
               rng.normal(50.0, 20.0, m).astype(np.float32),
               rng.random(m) < 0.9)


@pytest.mark.parametrize("seed,s,cap,n_max,m", [
    (0, 3, 16, 16, 100), (1, 4, 8, 32, 257), (2, 2, 40, 64, 999),
    (3, 4, [4, 9, 0, 30], 32, 64)])
def test_update_chunk_bitwise(seed, s, cap, n_max, m):
    """On CPU tensors the fold dispatches to its plain version."""
    jst = joasrs.init(s, jnp.asarray(cap, jnp.int32), SPEC,
                      jax.random.PRNGKey(seed), max_capacity=n_max)
    tst = oasrs.init(s, cap, prng.PRNGKey(seed), max_capacity=n_max,
                     device="cpu")
    for sid, pay, mask in _chunks(seed, 5, m, s):
        jst = _jax_update(jst, jnp.asarray(sid), jnp.asarray(pay),
                          jnp.asarray(mask), backend="jnp")
        tst = tdist.local_update(tst, torch.from_numpy(sid),
                                 torch.from_numpy(pay),
                                 torch.from_numpy(mask))
        np.testing.assert_array_equal(
            np.asarray(jst.values).view(np.int32),
            tst.values.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(jst.counts),
                                      tst.counts.numpy())
        np.testing.assert_array_equal(
            np.asarray(jst.key).astype(np.int64), tst.key.numpy())
    np.testing.assert_array_equal(np.asarray(jst.slot_mask()),
                                  tst.slot_mask().numpy())
    np.testing.assert_array_equal(np.asarray(jst.weights()),
                                  tst.weights().numpy())


def test_init_fresh_capacity_buffer_and_dtypes():
    cap = torch.tensor([4, 5, 6], dtype=torch.int32)
    st = oasrs.init(3, cap, prng.PRNGKey(0), device="cpu")
    assert st.capacity.data_ptr() != cap.data_ptr()
    st.capacity[0] = 99
    assert cap[0] == 4
    assert st.values.shape == (3, 6) and st.values.dtype == torch.float32
    assert st.counts.dtype == torch.int32 and st.capacity.dtype == torch.int32


def test_unknown_backend_raises():
    """The fold has no route option: it runs where its tensors lie."""
    st = oasrs.init(2, 4, prng.PRNGKey(0), device="cpu")
    with pytest.raises(TypeError, match="backend"):
        oasrs.update_chunk(st, torch.zeros(3, dtype=torch.int32),
                           torch.zeros(3), backend="pallas")


@pytest.mark.parametrize("seed", range(4))
def test_rank_within_stratum_and_bincount(seed):
    from repro import utils as jutils
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, 5, 300).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jutils.rank_within_stratum(jnp.asarray(sid))),
        utils.rank_within_stratum(torch.from_numpy(sid)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jutils.bincount(jnp.asarray(sid), 5)),
        utils.bincount(torch.from_numpy(sid), 5).numpy())
