"""The port's Eq. 5-9 estimators against the reference's: values within
rtol 1e-5, variances within rtol 1e-4 (s2 = sumsqs - Y*mean^2 cancels
digits, and the two sum in different orders). The Neyman capacity may
differ by 1 only where the value before ``ceil`` is within 1e-5 relative
of an integer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import error as jerr
from repro.runtime import controller as jctl
from repro_torch.core import adaptive, error as err
from repro_torch.runtime import controller as ctl

VALUE_RTOL, VAR_RTOL = 1e-5, 1e-4


def _sample(seed, g=6, n=48):
    """Reservoir contents ``[G, N]`` of cells with strata A/B/C-like
    spreads, arrivals ``C >= Y`` and a slot mask from ``taken``."""
    rng = np.random.default_rng(seed)
    mus = np.resize(np.array([10.0, 100.0, 1000.0], np.float32), g)
    xs = (mus[:, None] * (1.0 + 0.2 * rng.standard_normal((g, n)))).astype(
        np.float32)
    taken = rng.integers(0, n + 1, g).astype(np.int32)
    taken[0] = n                    # one full cell, one tiny
    taken[1] = 1
    counts = (taken + rng.integers(0, 5 * n, g) * (taken == n)).astype(
        np.int32)
    mask = np.arange(n)[None, :] < taken[:, None]
    return xs, counts, taken, mask


def _stats_pair(seed):
    xs, counts, taken, mask = _sample(seed)
    j = jerr.stratum_stats_from_sample(jnp.asarray(xs), jnp.asarray(counts),
                                       jnp.asarray(taken), jnp.asarray(mask))
    t = err.stratum_stats_from_sample(
        torch.from_numpy(xs), torch.from_numpy(counts),
        torch.from_numpy(taken), torch.from_numpy(mask))
    return j, t


def _close(a, b, rtol):
    np.testing.assert_allclose(np.asarray(b.detach().numpy()),
                               np.asarray(a), rtol=rtol, atol=0.0)


@pytest.mark.parametrize("seed", range(6))
def test_stats_and_estimators(seed):
    j, t = _stats_pair(seed)
    np.testing.assert_array_equal(np.asarray(j.counts), t.counts.numpy())
    np.testing.assert_array_equal(np.asarray(j.taken), t.taken.numpy())
    _close(j.sums, t.sums, VALUE_RTOL)
    _close(j.sumsqs, t.sumsqs, VALUE_RTOL)
    _close(j.mean(), t.mean(), VALUE_RTOL)
    _close(j.s2(), t.s2(), VAR_RTOL)
    for jf, tf in ((jerr.estimate_sum, err.estimate_sum),
                   (jerr.estimate_mean, err.estimate_mean)):
        je, te = jf(j), tf(t)
        _close(je.value, te.value, VALUE_RTOL)
        _close(je.variance, te.variance, VAR_RTOL)
        for conf in (0.68, 0.95, 0.997):
            _close(je.error_bound(conf), te.error_bound(conf), VAR_RTOL)
            for a, b in zip(je.interval(conf), te.interval(conf)):
                _close(a, b, VALUE_RTOL)
    _close(jerr.var_sum(j), err.var_sum(t), VAR_RTOL)
    _close(jerr.var_mean(j), err.var_mean(t), VAR_RTOL)


def test_merge_stats_and_bad_confidence():
    (j1, t1), (j2, t2) = _stats_pair(1), _stats_pair(2)
    jm, tm = jerr.merge_stats(j1, j2), err.merge_stats(t1, t2)
    for f in ("counts", "taken"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, f)),
                                      getattr(tm, f).numpy())
    _close(jerr.estimate_sum(jm).variance, err.estimate_sum(tm).variance,
           VAR_RTOL)
    with pytest.raises(ValueError, match="68-95-99.7"):
        err.estimate_sum(tm).error_bound(0.9)


def _pre_ceil(counts, s2, target, z):
    """The Neyman allocation before ``ceil``, in float64."""
    c = counts.astype(np.float64)
    omega = c / max(c.sum(), 1.0)
    s = np.sqrt(np.maximum(s2, 0.0))
    a = (omega * s).sum()
    b = (omega * omega * s2 / np.maximum(c, 1.0)).sum()
    n_total = a * a / max((target / z) ** 2 + b, 1e-20)
    return n_total * omega * s / a


def _assert_ceil_match(j, t, pre):
    j, t = np.asarray(j).astype(np.int64), t.numpy().astype(np.int64)
    diff = np.abs(j - t)
    assert diff.max() <= 1, (j, t)
    near = np.abs(pre - np.round(pre)) <= 1e-5 * np.abs(pre)
    assert np.all((diff == 0) | near), (j, t, pre)


@pytest.mark.parametrize("seed", range(8))
def test_neyman_allocation_and_next_capacity(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(100, 20000, 5).astype(np.int32)
    s2 = (rng.random(5) * 1e4).astype(np.float32)
    target = float(rng.uniform(0.5, 5.0))
    pre = _pre_ceil(counts, s2.astype(np.float64), target, 2.0)
    ja = jerr.required_sample_size_mean(
        jnp.asarray(counts), jnp.asarray(s2), jnp.float32(target),
        jnp.float32(2.0), min_per_stratum=1)
    ta = err.required_sample_size_mean(
        torch.from_numpy(counts), torch.from_numpy(s2),
        torch.tensor(target, dtype=torch.float32),
        torch.tensor(2.0, dtype=torch.float32), min_per_stratum=1)
    _assert_ceil_match(ja, ta, pre)

    # next_capacity and the controller: the stats carry these counts and
    # s2 (taken = counts, so the fpc vanishes only where it should).
    y = counts
    mean = np.float32(50.0)
    sums = (mean * y).astype(np.float32)
    sumsqs = (s2 * (y - 1) + y * mean * mean).astype(np.float32)
    jst = jerr.StratumStats(*(jnp.asarray(a) for a in (counts, y, sums,
                                                       sumsqs)))
    tst = err.StratumStats(*(torch.from_numpy(a) for a in (counts, y, sums,
                                                           sumsqs)))
    pre = _pre_ceil(counts, np.asarray(jst.s2(), np.float64), target, 2.0)
    jb = jad.accuracy_budget(target, 0.95, min_per_stratum=8,
                             max_per_stratum=4096)
    tb = adaptive.accuracy_budget(target, 0.95, min_per_stratum=8,
                                  max_per_stratum=4096)
    _assert_ceil_match(jad.next_capacity(jb, jst),
                       adaptive.next_capacity(tb, tst), pre)

    jc = jctl.init(jnp.full((5,), 64, jnp.int32))
    tc = ctl.init(torch.full((5,), 64, dtype=torch.int32))
    for latency in (0.01, 0.02):
        jc = jctl.update(jc, jctl.ControllerConfig(budget=jb), jst,
                         jerr.estimate_mean(jst), jnp.float32(latency),
                         intervals=2)
        tc = ctl.update(tc, ctl.ControllerConfig(budget=tb), tst,
                        err.estimate_mean(tst),
                        torch.tensor(latency, dtype=torch.float32),
                        intervals=2)
        assert np.abs(np.asarray(jc.capacity) - tc.capacity.numpy()).max() \
            <= 1
        _close(jc.latency_ema, tc.latency_ema, 1e-6)


def test_controller_without_budget_keeps_base_capacity_and_sheds():
    cap = torch.full((3,), 100, dtype=torch.int32)
    tc = ctl.init(cap)
    st = err.StratumStats(*(torch.ones(3, dtype=d) for d in (
        torch.int32, torch.int32, torch.float32, torch.float32)))
    est = err.estimate_mean(st)
    out = ctl.update(tc, ctl.ControllerConfig(), st, est,
                     torch.tensor(0.5))
    assert torch.equal(out.capacity, cap) and float(out.pressure) == 0.0
    shed = ctl.update(tc, ctl.ControllerConfig(latency_budget_s=0.25), st,
                      est, torch.tensor(0.5))
    jshed = jctl.update(jctl.init(jnp.full((3,), 100, jnp.int32)),
                        jctl.ControllerConfig(latency_budget_s=0.25),
                        jerr.StratumStats(*(jnp.ones(3, d) for d in (
                            jnp.int32, jnp.int32, jnp.float32,
                            jnp.float32))),
                        None, jnp.float32(0.5))
    np.testing.assert_array_equal(np.asarray(jshed.capacity),
                                  shed.capacity.numpy())
    assert float(shed.pressure) == pytest.approx(2.0)
