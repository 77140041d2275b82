"""The port's ``core/quantile.py`` against the reference, on the CPU.

Same numpy inputs through both. Bitwise: the flat view, the bootstrap
resample (the port's threefry ``randint`` is the reference's). The
reference's ``jnp.cumsum`` and the port's fixed-order scan round in
different orders, so a target that falls within rounding of a cumulative
weight may pick the neighbouring sorted slot: ``weighted_quantile`` must
return the reference's value or a valid sorted neighbour, and
``quantile_refine`` lie within ``2·(hi0−lo0)/B^R`` of it. Bootstrap
variances agree within rtol 1e-3 where every replicate agrees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oasrs as joasrs
from repro.core import quantile as jqt
from repro_torch import prng
from repro_torch.core import oasrs as toasrs
from repro_torch.core import quantile as tqt

QS = (0.01, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0)


def _view_arrays(seed, g=6, n=96, dyadic=False):
    """``(values, counts, taken)`` of ``g`` cells: flow-size-like values
    floored to integers (so ties occur), counts above or below capacity.
    ``dyadic`` makes every capacity 16 so weights C/16 are exact sums."""
    rng = np.random.default_rng(seed)
    vals = np.floor(rng.lognormal(4.0, 1.0, (g, n))).astype(np.float32)
    counts = rng.integers(5, 400, g).astype(np.int32)
    cap = np.full(g, 16) if dyadic else rng.integers(8, n + 1, g)
    taken = np.minimum(counts, cap).astype(np.int32)
    taken[0] = 0                                       # an empty cell
    return vals, counts, taken


def _views(arrays):
    j = jqt.SampleView(*(jnp.asarray(a) for a in arrays))
    t = tqt.SampleView(*(torch.from_numpy(a) for a in arrays))
    return j, t


def _assert_neighbour(jv, tv, x, valid):
    """Each port quantile equals the reference's or a valid sorted
    neighbour of it."""
    xs = np.unique(x[valid])
    for a, b in zip(np.asarray(jv), np.asarray(tv)):
        if a == b:
            continue
        i = np.searchsorted(xs, a)
        assert b in xs[max(i - 1, 0): i + 2], (a, b)


def test_flat_and_weights_bitwise():
    jv, tv = _views(_view_arrays(0))
    for a, b in zip(jv.flat(), tv.flat()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jv.weights()),
                                  tv.weights().numpy())


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dyadic", [False, True])
def test_weighted_quantile_equal_or_neighbour(seed, dyadic):
    jv, tv = _views(_view_arrays(seed, dyadic=dyadic))
    jx, jw, jm, _ = jv.flat()
    tx, tw, tm, _ = tv.flat()
    a = jqt.weighted_quantile(jx, jw, jm, jnp.asarray(QS, jnp.float32))
    b = tqt.weighted_quantile(tx, tw, tm, QS)
    if dyadic:
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _assert_neighbour(a, b.numpy(), tx.numpy(), tm.numpy())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("num_bins,num_steps", [(32, 4), (8, 3)])
def test_quantile_refine_within_resolution(seed, num_bins, num_steps):
    arrays = _view_arrays(seed)
    jv, tv = _views(arrays)
    a = np.asarray(jqt.quantile_refine(jv, jnp.asarray(QS, jnp.float32),
                                       num_bins=num_bins,
                                       num_steps=num_steps))
    b = tqt.quantile_refine(tv, QS, num_bins=num_bins,
                            num_steps=num_steps).numpy()
    x = tv.flat()[0].numpy()[tv.flat()[2].numpy()]
    tol = 2 * (x.max() - x.min()) / num_bins ** num_steps
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def test_quantile_refine_collapsed_bracket():
    """A window of one repeated value: every edge equals it, so all mass
    is in the last bin and the answer is that value."""
    vals = np.full((3, 16), 1480.0, np.float32)
    arrays = (vals, np.array([40, 9, 0], np.int32),
              np.array([16, 9, 0], np.int32))
    jv, tv = _views(arrays)
    a = np.asarray(jqt.quantile_refine(jv, jnp.asarray(QS, jnp.float32)))
    b = tqt.quantile_refine(tv, QS).numpy()
    np.testing.assert_array_equal(b, a)
    assert (b == 1480.0).all()


@pytest.mark.parametrize("seed", range(3))
def test_cell_counts_match(seed):
    jv, tv = _views(_view_arrays(seed))
    edges = np.array([0, 8, 16, 32, 64, 128, 256, 1e6], np.float32)
    a = jqt.cell_counts(jv, jnp.asarray(edges))
    b = tqt.cell_counts(tv, torch.from_numpy(edges))
    np.testing.assert_allclose(b.value.numpy(), np.asarray(a.value),
                               rtol=1e-5)
    np.testing.assert_allclose(b.variance.numpy(), np.asarray(a.variance),
                               rtol=1e-4)


def test_invert_weighted_cdf_matches():
    rng = np.random.default_rng(2)
    hist = rng.uniform(0, 10, 16).astype(np.float32)
    hist[[3, 4]] = 0.0
    edges = np.linspace(5.0, 21.0, 17).astype(np.float32)
    targets = np.array([0.5, 7.0, 20.0, 60.0, 200.0], np.float32)
    a = jqt.invert_weighted_cdf(jnp.asarray(hist), jnp.asarray(edges),
                                jnp.float32(1.0), jnp.asarray(targets))
    b = tqt.invert_weighted_cdf(torch.from_numpy(hist),
                                torch.from_numpy(edges),
                                torch.tensor(1.0), torch.from_numpy(targets))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 5, 77])
def test_bootstrap_resample_bitwise(seed):
    jv, tv = _views(_view_arrays(seed, n=200))
    a = jqt.bootstrap_resample(jv, jax.random.PRNGKey(seed))
    b = tqt.bootstrap_resample(tv, prng.PRNGKey(seed))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed", range(3))
def test_bootstrap_replicates_and_variance(seed):
    arrays = _view_arrays(seed)
    jv, tv = _views(arrays)
    a = np.asarray(jqt.bootstrap_quantiles(
        jv, jnp.asarray(QS, jnp.float32), 12, jax.random.PRNGKey(seed)))
    b = tqt.bootstrap_quantiles(tv, QS, 12, prng.PRNGKey(seed)).numpy()
    x, _, valid, _ = tv.flat()
    for r in range(12):
        _assert_neighbour(a[r], b[r], x.numpy(), valid.numpy())
    same = (a == b).all(axis=0)
    assert same.any()
    np.testing.assert_allclose(b.var(axis=0, ddof=1)[same],
                               a.var(axis=0, ddof=1)[same], rtol=1e-3)
    je = jqt.query_quantile(jv, QS, num_replicates=12,
                            key=jax.random.PRNGKey(seed))
    te = tqt.query_quantile(tv, QS, num_replicates=12,
                            key=prng.PRNGKey(seed))
    np.testing.assert_allclose(te.variance.numpy()[same],
                               np.asarray(je.variance)[same], rtol=1e-3)


def test_query_quantile_on_a_state_folds_its_key():
    rng = np.random.default_rng(3)
    sid = rng.integers(0, 3, 500).astype(np.int32)
    x = np.floor(rng.lognormal(3.0, 1.0, 500)).astype(np.float32)
    js = joasrs.update_chunk(
        joasrs.init(3, 32, jnp.float32(0), jax.random.PRNGKey(1)),
        jnp.asarray(sid), jnp.asarray(x))
    ts = toasrs.update_chunk(toasrs.init(3, 32, prng.PRNGKey(1),
                                         device="cpu"),
                             torch.from_numpy(sid), torch.from_numpy(x))
    for method in ("sort", "hist"):
        a = jqt.query_quantile(js, QS, method=method, num_replicates=8)
        b = tqt.query_quantile(ts, QS, method=method, num_replicates=8)
        np.testing.assert_array_equal(b.value.numpy(), np.asarray(a.value))
        np.testing.assert_allclose(b.variance.numpy(),
                                   np.asarray(a.variance), rtol=1e-3)


def test_query_quantile_argument_errors():
    _, tv = _views(_view_arrays(0))
    with pytest.raises(ValueError, match="key="):
        tqt.query_quantile(tv, QS)
    with pytest.raises(ValueError, match="unknown method"):
        tqt.query_quantile(tv, QS, method="tdigest", num_replicates=0)
    zero = tqt.query_quantile(tv, QS, num_replicates=0)
    assert (zero.variance.numpy() == 0).all()


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_fixed_order_cumsum(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(0, 5, n).astype(np.float32)
    got = tqt.fixed_order_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.cumsum(x, dtype=np.float64),
                               rtol=1e-6)
    seg = np.sort(rng.integers(0, max(n // 5, 1), n))
    got = tqt.fixed_order_cumsum(torch.from_numpy(x),
                                 torch.from_numpy(seg)).numpy()
    want = np.concatenate([np.cumsum(x[seg == s], dtype=np.float64)
                           for s in np.unique(seg)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
