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


# ---------------------------------------------------------------------------
# The rest of the module: reset_window, the pipelined model, extraction,
# and the window ring's slide / capacity / windowed queries.
# ---------------------------------------------------------------------------

def _same_state(jst, tst):
    np.testing.assert_array_equal(np.asarray(jst.values).view(np.int32),
                                  tst.values.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(jst.counts), tst.counts.numpy())
    np.testing.assert_array_equal(np.asarray(jst.capacity),
                                  tst.capacity.numpy())
    np.testing.assert_array_equal(np.asarray(jst.key).astype(np.int64),
                                  tst.key.numpy())


def _pair(seed, s, cap, n_max):
    jst = joasrs.init(s, jnp.asarray(cap, jnp.int32), SPEC,
                      jax.random.PRNGKey(seed), max_capacity=n_max)
    tst = oasrs.init(s, cap, prng.PRNGKey(seed), max_capacity=n_max,
                     device="cpu")
    return jst, tst


@pytest.mark.parametrize("seed,s,cap,n_max", [
    (0, 3, 16, 16), (1, 4, [4, 9, 0, 30], 32), (2, 2, 1, 8)])
def test_update_stream_bitwise(seed, s, cap, n_max):
    """Algorithm 1 item by item, T = 200: values, counts and key bit for
    bit the reference's ``lax.scan`` (replacements drawn by ``randint``
    over ``max(cap, 1)``, a tensor bound)."""
    jst, tst = _pair(seed, s, cap, n_max)
    sid, pay, mask = next(_chunks(seed + 10, 1, 200, s))
    jst = jax.jit(joasrs.update_stream)(jst, jnp.asarray(sid),
                                        jnp.asarray(pay), jnp.asarray(mask))
    tst = oasrs.update_stream(tst, torch.from_numpy(sid),
                              torch.from_numpy(pay), torch.from_numpy(mask))
    _same_state(jst, tst)


def test_update_item_default_mask():
    jst, tst = _pair(5, 3, 2, 4)
    for sid, x in ((0, 1.5), (0, 2.5), (0, 3.5), (2, -1.0), (0, 4.5)):
        jst = joasrs.update_item(jst, jnp.int32(sid), jnp.float32(x))
        tst = oasrs.update_item(tst, torch.tensor(sid),
                                torch.tensor(x, dtype=torch.float32))
    _same_state(jst, tst)
    assert tst.counts.tolist() == [4, 0, 1]


@pytest.mark.parametrize("lane", [64, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_update_pipelined_chunks_bitwise(lane, masked):
    """One fold per lane in stream order, the reference's scan of
    ``update_chunk`` over the lanes: bitwise at the same lane."""
    jst, tst = _pair(lane, 3, 40, 48)
    sid, pay, mask = next(_chunks(lane + 1, 1, 1024, 3))
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    jst = jax.jit(joasrs.update_pipelined_chunks,
                  static_argnames="lane")(jst, jnp.asarray(sid),
                                          jnp.asarray(pay), lane=lane,
                                          mask=jm)
    tst = oasrs.update_pipelined_chunks(tst, torch.from_numpy(sid),
                                        torch.from_numpy(pay), lane=lane,
                                        mask=tm)
    _same_state(jst, tst)


def test_update_pipelined_chunks_lane_error():
    tst = oasrs.init(3, 8, prng.PRNGKey(0), device="cpu")
    ids = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible by lane 64"):
        oasrs.update_pipelined_chunks(tst, ids, ids.float(), lane=64)
    with pytest.raises(ValueError, match="not divisible"):
        joasrs.update_pipelined_chunks(
            joasrs.init(3, 8, SPEC, jax.random.PRNGKey(0)),
            jnp.zeros(100, jnp.int32), jnp.zeros(100), lane=64)


def test_reset_window_and_sample_with_weights():
    jst, tst = _pair(7, 3, [5, 9, 2], 9)
    sid, pay, mask = next(_chunks(8, 1, 60, 3))
    jst = joasrs.update_chunk(jst, jnp.asarray(sid), jnp.asarray(pay),
                              jnp.asarray(mask), backend="jnp")
    tst = oasrs.update_chunk(tst, torch.from_numpy(sid),
                             torch.from_numpy(pay), torch.from_numpy(mask))
    for jo, to in zip(joasrs.sample_with_weights(jst),
                      oasrs.sample_with_weights(tst)):
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    xs, w, valid = oasrs.sample_with_weights(tst, extract=lambda v: 2 * v)
    assert xs.shape == w.shape == valid.shape == (27,)
    jr, tr = joasrs.reset_window(jst), oasrs.reset_window(tst)
    _same_state(jr, tr)
    assert tr.counts.tolist() == [0, 0, 0] and not tr.slot_mask().any()
    assert tst.counts.sum() > 0           # the input state is untouched


def _window_pair(seed, k=3, s=3, cap=6):
    from repro.core import window as jwin
    from repro_torch.core import window as twin
    jw = jwin.init(k, s, cap, SPEC, jax.random.PRNGKey(seed))
    tw = twin.init(k, s, cap, prng.PRNGKey(seed), device="cpu")
    return jwin, twin, jw, tw


def _same_window(jw, tw):
    _same_state(jw.intervals, tw.intervals)
    assert int(jw.cursor) == int(tw.cursor)
    assert int(jw.filled) == int(tw.filled)


@pytest.mark.parametrize("seed", range(3))
def test_window_slide_capacity_and_queries(seed):
    """``slide`` five fresh intervals through a ring of 3 (wrapping),
    ``interval_capacity`` and ``with_capacity`` bit for bit; the windowed
    SUM and MEAN within rtol 1e-5 (the stats pass sums in another
    order)."""
    jwin, twin, jw, tw = _window_pair(seed)
    chunks = _chunks(seed + 20, 5, 50, 3)
    for i, (sid, pay, mask) in enumerate(chunks):
        cap = [4, 6, 2 + i % 3]
        jf, tf = _pair(seed * 10 + i, 3, cap, 6)
        jf = joasrs.update_chunk(jf, jnp.asarray(sid), jnp.asarray(pay),
                                 jnp.asarray(mask), backend="jnp")
        tf = oasrs.update_chunk(tf, torch.from_numpy(sid),
                                torch.from_numpy(pay),
                                torch.from_numpy(mask))
        jw, tw = jwin.slide(jw, jf), twin.slide(tw, tf)
        _same_window(jw, tw)
        np.testing.assert_array_equal(np.asarray(jwin.interval_capacity(jw)),
                                      twin.interval_capacity(tw).numpy())
        for name in ("query_sum", "query_mean"):
            je, te = getattr(jwin, name)(jw), getattr(twin, name)(tw)
            np.testing.assert_allclose(te.value.numpy(), np.asarray(je.value),
                                       rtol=1e-5)
            np.testing.assert_allclose(te.variance.numpy(),
                                       np.asarray(je.variance), rtol=1e-5)
    new_cap = np.array([1, 5, 3], np.int32)
    jw2 = jwin.with_capacity(jw, jnp.asarray(new_cap))
    tw2 = twin.with_capacity(tw, torch.from_numpy(new_cap))
    _same_window(jw2, tw2)
    assert tw.intervals.capacity.data_ptr() != \
        tw2.intervals.capacity.data_ptr()
