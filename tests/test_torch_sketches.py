"""The port's ``core/sketches.py`` and ``core/query.py`` against the
reference, on the CPU.

Bitwise: the distinct-value segmentation, the heavy-hitter keys in order
(ties keep the lower segment first, as ``jax.lax.top_k`` does), the
Chao1 value. Within rtol: heavy-hitter estimates and sample weights
(1e-5), their variances (1e-4), bootstrap variances (1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oasrs as joasrs
from repro.core import query as jquery
from repro.core import quantile as jqt
from repro.core import sketches as jsk
from repro_torch import prng
from repro_torch.core import oasrs as toasrs
from repro_torch.core import query as tquery
from repro_torch.core import quantile as tqt
from repro_torch.core import sketches as tsk


def _views(seed, g=6, n=128, distinct=40, dyadic=False):
    """Cells of integer keys drawn from a skewed law over ``distinct``
    values (many exact ties in frequency), counts above and below the
    capacities."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, distinct + 1) ** 1.1
    vals = rng.choice(distinct, (g, n), p=p / p.sum()).astype(np.float32)
    counts = rng.integers(5, 600, g).astype(np.int32)
    cap = np.full(g, 16) if dyadic else rng.integers(8, n + 1, g)
    taken = np.minimum(counts, cap).astype(np.int32)
    arrays = (vals, counts, taken)
    return (jqt.SampleView(*(jnp.asarray(a) for a in arrays)),
            tqt.SampleView(*(torch.from_numpy(a) for a in arrays)))


@pytest.mark.parametrize("seed", range(3))
def test_segments_bitwise(seed):
    jv, tv = _views(seed)
    jx, _, jm, _ = jv.flat()
    tx, _, tm, _ = tv.flat()
    for a, b in zip(jsk._segments(jx, jm), tsk._segments(tx, tm)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("dyadic", [False, True])
def test_heavy_hitters_match(seed, k, dyadic):
    jv, tv = _views(seed, dyadic=dyadic)
    a, b = jsk.query_heavy_hitters(jv, k), tsk.query_heavy_hitters(tv, k)
    np.testing.assert_array_equal(b.keys.numpy(), np.asarray(a.keys))
    np.testing.assert_allclose(b.sample_weight.numpy(),
                               np.asarray(a.sample_weight), rtol=1e-5)
    np.testing.assert_allclose(b.estimate.value.numpy(),
                               np.asarray(a.estimate.value), rtol=1e-5)
    np.testing.assert_allclose(b.estimate.variance.numpy(),
                               np.asarray(a.estimate.variance), rtol=1e-4)


def test_heavy_hitters_exact_ties_keep_lower_segment_first():
    """Every key sampled exactly twice in one cell of weight 1: all
    weights tie, so the order is the sorted key order."""
    vals = np.array([[5.0, 3.0, 9.0, 3.0, 5.0, 9.0, 1.0, 1.0]], np.float32)
    arrays = (vals, np.array([8], np.int32), np.array([8], np.int32))
    jv = jqt.SampleView(*(jnp.asarray(a) for a in arrays))
    tv = tqt.SampleView(*(torch.from_numpy(a) for a in arrays))
    a, b = jsk.query_heavy_hitters(jv, 3), tsk.query_heavy_hitters(tv, 3)
    np.testing.assert_array_equal(b.keys.numpy(), np.asarray(a.keys))
    np.testing.assert_array_equal(b.keys.numpy(), [1.0, 3.0, 5.0])


def test_heavy_hitters_pad_when_fewer_keys_than_k():
    jv, tv = _views(1, distinct=3)
    a, b = jsk.query_heavy_hitters(jv, 6), tsk.query_heavy_hitters(tv, 6)
    np.testing.assert_array_equal(b.keys.numpy(), np.asarray(a.keys))
    assert (b.keys.numpy()[3:] == np.float32(3.0e38)).all()
    assert (b.estimate.value.numpy()[3:] == 0).all()


@pytest.mark.parametrize("seed", range(3))
def test_key_counts_match(seed):
    jv, tv = _views(seed)
    keys = np.array([0.0, 1.0, 2.0, 7.0, 99.0], np.float32)
    a = jsk.key_counts(jv, jnp.asarray(keys))
    b = tsk.key_counts(tv, torch.from_numpy(keys))
    np.testing.assert_allclose(b.value.numpy(), np.asarray(a.value),
                               rtol=1e-5)
    np.testing.assert_allclose(b.variance.numpy(), np.asarray(a.variance),
                               rtol=1e-4)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("distinct", [5, 40, 400])
def test_chao1_bitwise(seed, distinct):
    jv, tv = _views(seed, distinct=distinct)
    a = jsk._chao1(jv.values.reshape(-1), jv.slot_mask().reshape(-1))
    b = tsk._chao1(tv.values.reshape(-1), tv.slot_mask().reshape(-1))
    assert np.float32(a) == b.numpy()


@pytest.mark.parametrize("seed", range(3))
def test_query_distinct_match(seed):
    jv, tv = _views(seed, distinct=400)
    a = jsk.query_distinct(jv, num_replicates=10,
                           key=jax.random.PRNGKey(seed))
    b = tsk.query_distinct(tv, num_replicates=10, key=prng.PRNGKey(seed))
    assert np.float32(a.value) == b.value.numpy()
    np.testing.assert_allclose(b.variance.numpy(), np.asarray(a.variance),
                               rtol=1e-3)
    with pytest.raises(ValueError, match="key="):
        tsk.query_distinct(tv)


def _states():
    """One OASRS state in each package after the same chunk."""
    rng = np.random.default_rng(9)
    sid = rng.integers(0, 3, 600).astype(np.int32)
    x = np.floor(rng.lognormal(3.0, 1.0, 600)).astype(np.float32)
    js = joasrs.update_chunk(
        joasrs.init(3, 64, jnp.float32(0), jax.random.PRNGKey(2)),
        jnp.asarray(sid), jnp.asarray(x))
    ts = toasrs.update_chunk(toasrs.init(3, 64, prng.PRNGKey(2),
                                         device="cpu"),
                             torch.from_numpy(sid), torch.from_numpy(x))
    return js, ts, (x, sid)


_EDGES = (0.0, 4.0, 16.0, 64.0, 256.0, 1e5)
SINGLE_STATE = {
    "sum": (lambda m, s: m.query_sum(s), False),
    "mean": (lambda m, s: m.query_mean(s), False),
    "count": (lambda m, s: m.query_count(s, lambda x: x > 20.0), False),
    "linear": (lambda m, s: m.query_linear(s, lambda x: 2.0 * x + 1.0),
               False),
    "group_means": (lambda m, s: m.group_means(s), False),
    "histogram": (lambda m, s: m.query_histogram(
        s, (jnp if m is jquery else torch).asarray(_EDGES)), False),
    "quantile": (lambda m, s: m.query_quantile(s, (0.5, 0.9),
                                               num_replicates=8), True),
    "distinct": (lambda m, s: m.query_distinct(s, num_replicates=8), True),
    "heavy_hitters": (lambda m, s: m.query_heavy_hitters(s, 4).estimate,
                      False),
}


@pytest.mark.parametrize("name", sorted(SINGLE_STATE))
def test_single_state_queries_match(name):
    js, ts, _ = _states()
    fn, boot = SINGLE_STATE[name]
    a, b = fn(jquery, js), fn(tquery, ts)
    np.testing.assert_allclose(b.value.numpy(), np.asarray(a.value),
                               rtol=1e-5)
    np.testing.assert_allclose(b.variance.numpy(), np.asarray(a.variance),
                               rtol=1e-3 if boot else 1e-4)


def test_exact_stats_match():
    _, _, (x, sid) = _states()
    mask = np.arange(600) % 7 != 0
    a = jquery.exact_stats(jnp.asarray(x), jnp.asarray(sid), 3,
                           jnp.asarray(mask))
    b = tquery.exact_stats(torch.from_numpy(x), torch.from_numpy(sid), 3,
                           torch.from_numpy(mask))
    for f in ("counts", "taken"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)))
    for f in ("sums", "sumsqs"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-5)
