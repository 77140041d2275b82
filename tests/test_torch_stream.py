"""The port's stream substrate against the reference's, on the CPU.

``prng.normal`` / ``choice`` / ``uniform(minval, maxval)`` / ``gamma``
and XLA's CPU ``exp`` / ``log`` / ``pow`` bit for bit; the four sources
and the token window's Zipf weights bit for bit;
the aggregator, the records helpers and ``ReplayableStream`` bit for bit
(disorder, key gaps, W = 4); ``MeteredStream``, ``Prefetcher``,
``skewed`` and the token window as the reference's own tests hold them;
and a whole replayed run: the reference's ``PipelinedExecutor`` on its
``ReplayableStream`` against the port's on the port's, every integer and
sampling leaf of the state bit for bit.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.stream as jstream
from repro.runtime import executor as jex
from repro.runtime import records as jrec
from repro.runtime import registry as jregistry
from repro.stream import pipeline as jpipe
from repro.stream import replay as jreplay
import repro_torch.stream as tstream
from repro_torch import prng
from repro_torch.runtime import executor as tex
from repro_torch.runtime import records as trec
from repro_torch.stream import pipeline as tpipe
from repro_torch.stream import replay as treplay
from test_torch_checkpoint import linear_registry
from test_torch_executors import _assert_same_run

SOURCES = ("GaussianSource", "PoissonSource", "NetflowSource", "TaxiSource")
MIXES3 = ((1 / 3, 1 / 3, 1 / 3), (0.85, 0.13, 0.02), (0.8, 0.19, 0.01),
          (0.8, 0.1999, 0.0001), (0.5, 0.5, 0.0), (2.0, 1.0, 1.0))
TAXI_MIX = (0.55, 0.20, 0.12, 0.08, 0.04, 0.01)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several worker
    processes on the same cores, and torch's thread pool contending with
    them makes these many small operations tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t)


def _bits(a, b):
    """Bit for bit (floats compared as their int32 words)."""
    a, b = _np(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


# ---------------------------------------------------------------------------
# prng: normal, choice, uniform bounds, gamma.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_normal_bitwise_at_a_million_draws(seed):
    """Giles' erf_inv over XLA's CPU log1p, every contracted multiply-add
    fused: 1,048,576 draws, none differs."""
    jk, tk = _keys(seed)
    _bits(jax.random.normal(jk, (1 << 20,)), prng.normal(tk, 1 << 20))


def test_normal_shapes_and_leading_key_axes():
    jk, tk = _keys(5)
    _bits(jax.random.normal(jk, (7, 33)), prng.normal(tk, (7, 33)))
    jks, tks = jax.random.split(jk, 4), prng.split(tk, 4)
    _bits(jax.vmap(lambda k: jax.random.normal(k, (129,)))(jks),
          prng.normal(tks, 129))
    _bits(jax.vmap(lambda k: jax.random.normal(k, ()))(jks),
          prng.normal(tks, ()))


@pytest.mark.parametrize("lo,hi", [(-3.0, 7.5), (0.25, 0.5),
                                   (float(np.nextafter(np.float32(-1),
                                                       np.float32(0))), 1.0)])
def test_uniform_bounds_bitwise(lo, hi):
    jk, tk = _keys(9)
    _bits(jax.random.uniform(jk, (5000,), minval=lo, maxval=hi),
          prng.uniform(tk, 5000, lo, hi))


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("mix", MIXES3 + (TAXI_MIX,))
def test_choice_bitwise_every_mix(seed, mix):
    jk, tk = _keys(seed)
    p = np.asarray(jnp.asarray(mix, jnp.float32))
    want = jax.random.choice(jk, len(mix), (4096,), p=jnp.asarray(p))
    got = prng.choice(tk, len(mix), 4096, torch.from_numpy(p.copy()))
    np.testing.assert_array_equal(_np(want), got.numpy())


@pytest.mark.parametrize("n", [5, 17, 100, 1000, 5000])
def test_choice_bitwise_zipf_and_cumsum_order(n):
    """The token window's Zipf ``p`` (computed by the reference): the
    cumulative sum in XLA's order (blocks of 16) and the sum (windows of
    32) bit for bit, and every draw."""
    jk, tk = _keys(n)
    r = jnp.arange(1, n + 1, dtype=jnp.float32)
    p = 1.0 / r ** 1.1
    p = np.asarray(p / jnp.sum(p))
    tp = torch.from_numpy(p.copy())
    _bits(jnp.cumsum(p), prng.xla_cumsum(tp))
    _bits(jnp.sum(1.0 / r), prng.xla_sum(1.0 / torch.arange(
        1, n + 1, dtype=torch.float32)))
    want = jax.random.choice(jk, n, (64, 32), p=jnp.asarray(p))
    np.testing.assert_array_equal(_np(want),
                                  prng.choice(tk, n, (64, 32), tp).numpy())


def test_choice_rejects_a_wrong_p():
    with pytest.raises(ValueError, match="expected"):
        prng.choice(prng.PRNGKey(0), 3, 8, torch.ones(4))


@pytest.mark.parametrize("a", [0.5, 2.0, 3.0])
def test_gamma_moments_and_reference(a):
    """Marsaglia–Tsang on the threefry stream: mean and variance within 5
    standard errors of ``a`` at 65,536 draws (the boost path for a < 1
    too), and the first 2,048 draws bit for bit the reference's (its
    ``log``, ``rsqrt`` and ``pow`` rebuilt from XLA's CPU code)."""
    jk, tk = _keys(int(a * 10))
    n = 65536
    g = prng.gamma(tk, torch.full((n,), a)).double().numpy()
    se_mean = np.sqrt(a / n)
    se_var = np.sqrt((6 * a + 2 * a * a) * a * a / n) * 1.2
    assert abs(g.mean() - a) < 5 * se_mean
    assert abs(g.var() - a) < 5 * se_var
    _bits(jax.random.gamma(jk, jnp.full((2048,), a)),
          prng.gamma(tk, torch.full((2048,), a)))


def test_xla_exp_log_bitwise():
    """``xla_exp`` over [-90, 90] (subnormal results flushed to zero, as
    the backend flushes them) and ``xla_log`` over (0, 90]: 262,144
    values each, none differs from ``jnp.exp`` / ``jnp.log``."""
    x = np.random.default_rng(4).uniform(-90, 90, 1 << 18).astype(
        np.float32)
    _bits(jnp.exp(x), prng.xla_exp(torch.from_numpy(x)))
    y = np.abs(x) + np.float32(1e-3)
    _bits(jnp.log(y), prng.xla_log(torch.from_numpy(y)))


@pytest.mark.parametrize("power", [1.1, 0.37, 2.5])
def test_xla_pow_bitwise(power):
    """glibc's ``powf`` (what XLA's CPU ``pow`` calls) rebuilt in f64:
    100,000 pairs of a base in (0, 1] or in [1, 4096) and a fixed or a
    drawn exponent, none differs from ``jnp.power``."""
    rng = np.random.default_rng(int(power * 100))
    x = np.concatenate([rng.uniform(1e-6, 1.0, 50_000),
                        rng.uniform(1.0, 4096.0, 50_000)]).astype(np.float32)
    _bits(jnp.power(x, np.float32(power)),
          prng.xla_pow(torch.from_numpy(x), power))
    y = rng.uniform(0.2, 5.0, x.shape[0]).astype(np.float32)
    _bits(jnp.power(np.minimum(x, 1.0), y),
          prng.xla_pow(torch.from_numpy(np.minimum(x, 1.0)),
                       torch.from_numpy(y)))


def test_zipf_weights_bitwise_at_phi4_vocabulary():
    """The token window's Zipf(1.1) weights at phi4-mini-3.8b's vocabulary
    of 200,064, normalised: every weight bit for bit the reference's
    ``1 / r**1.1 / sum`` (before ``xla_pow`` 95 differed)."""
    r = jnp.arange(1, 200064 + 1, dtype=jnp.float32)
    w = 1.0 / r ** 1.1
    _bits(w / jnp.sum(w), tpipe._zipf(200064, 1.1, "cpu"))


# ---------------------------------------------------------------------------
# Sources and the aggregator.
# ---------------------------------------------------------------------------

def _sources(name, mix=None):
    j, t = getattr(jstream, name)(), getattr(tstream, name)()
    if mix is not None:
        j, t = jstream.skewed(j, mix), tstream.skewed(t, mix)
    return j, t


@pytest.mark.parametrize("name", SOURCES)
@pytest.mark.parametrize("skew", [False, True])
def test_sources_against_the_reference(name, skew):
    """Ids and values bit for bit, all four sources."""
    mix = None
    if skew:
        mix = TAXI_MIX[::-1] if name == "TaxiSource" else (0.8, 0.19, 0.01)
    js, ts = _sources(name, mix)
    jk, tk = _keys(11)
    a, b = js.chunk(jk, 4096), ts.chunk(tk, 4096)
    _bits(a.stratum_ids, b.stratum_ids)
    _bits(a.values, b.values)
    c = ts.chunk(tk, 4096)
    _bits(b.values.numpy(), c.values)


def test_taxi_moments_per_borough():
    """262,144 rides: every borough's mean and variance within 5 standard
    errors of ``shape·scale`` and ``shape·scale²``."""
    src = tstream.TaxiSource()
    c = src.chunk(prng.PRNGKey(2), 262144)
    vals, sid = c.values.double().numpy(), c.stratum_ids.numpy()
    for i, (k, th) in enumerate(zip(src.shape, src.scale)):
        x = vals[sid == i]
        n = len(x)
        mean, var = k * th, k * th * th
        se_var = np.sqrt((6 / k + 2) * var * var / n)
        assert abs(x.mean() - mean) < 5 * np.sqrt(var / n), i
        assert abs(x.var() - var) < 5 * se_var, i


@pytest.mark.parametrize("name", SOURCES)
def test_aggregator_keys_and_chunks(name):
    js, ts = _sources(name)
    ja = jstream.StreamAggregator(js, seed=42)
    ta = tstream.StreamAggregator(ts, seed=42, device="cpu")
    for e in (0, 3, 2**31 - 1):
        np.testing.assert_array_equal(_np(ja.epoch_key(e)).astype(np.int64),
                                      ta.epoch_key(e).numpy())
    _bits(ja.interval_chunk(3, 512).stratum_ids,
          ta.interval_chunk(3, 512).stratum_ids)
    a, b = ja.sharded_interval(2, 4, 256), ta.sharded_interval(2, 4, 256)
    assert tuple(b.values.shape) == (4, 256)
    _bits(a.stratum_ids, b.stratum_ids)
    one = ta.shard_chunk(2, 1, 4, 256)
    _bits(ja.shard_chunk(2, 1, 4, 256).stratum_ids, one.stratum_ids)
    _bits(b.values[1].numpy(), one.values)
    if name == "GaussianSource":
        _bits(a.values, b.values)


def test_aggregator_replay_and_distinct_shards():
    agg = tstream.StreamAggregator(tstream.GaussianSource(), seed=42,
                                   device="cpu")
    a, b = agg.interval_chunk(3, 128), agg.interval_chunk(3, 128)
    assert torch.equal(a.values, b.values)
    assert not torch.equal(a.values, agg.interval_chunk(4, 128).values)
    sc = agg.sharded_interval(0, 4, 64)
    assert not torch.equal(sc.values[0], sc.values[1])


# ---------------------------------------------------------------------------
# Records: the timestamped stream, silence, disorder.
# ---------------------------------------------------------------------------

def _aggs(seed=3, name="NetflowSource"):
    js, ts = _sources(name)
    return (jstream.StreamAggregator(js, seed=seed),
            tstream.StreamAggregator(ts, seed=seed, device="cpu"))


def _same_chunk(a, b, values=True):
    for f in ("stratum_ids", "times", "mask") + (("values",) if values
                                                 else ()):
        _bits(getattr(a, f), getattr(b, f))


def test_timestamped_stream_bitwise():
    ja, ta = _aggs()
    js = list(jrec.timestamped_stream(ja, 128, 4, 300.0, start_epoch=2))
    ts = list(trec.timestamped_stream(ta, 128, 4, 300.0, start_epoch=2))
    assert len(js) == len(ts) == 4
    for a, b in zip(js, ts):
        _same_chunk(a, b, values=False)


@pytest.mark.parametrize("sharded", [False, True])
def test_perturb_and_silence_bitwise(sharded):
    """``perturb_event_times`` over a suffix and over the whole stream,
    then ``silence_key`` (fmod with the sign fix) on the disordered
    times, for ``[M]`` and ``[W, M]`` chunks."""
    ja, ta = _aggs(5, "GaussianSource")
    if sharded:
        jc = [jrec.stamp_sharded(ja.sharded_interval(e, 4, 96), e * 0.75,
                                 128.0) for e in range(5)]
        tc = []
        for e in range(5):
            c = ta.sharded_interval(e, 4, 96)
            tc.append(trec.stamp_sharded(c.values, c.stratum_ids, e * 0.75,
                                         128.0))
    else:
        jc = list(jrec.timestamped_stream(ja, 96, 5, 128.0))
        tc = list(trec.timestamped_stream(ta, 96, 5, 128.0))
    jp = jrec.perturb_event_times(jc, jax.random.PRNGKey(7), 0.6)
    tp = trec.perturb_event_times(tc, prng.PRNGKey(7), 0.6)
    tail = trec.perturb_event_times(tc[2:], prng.PRNGKey(7), 0.6, offset=2)
    for a, b in zip(jp, tp):
        _same_chunk(a, b)
    for a, b in zip(tp[2:], tail):
        assert torch.equal(a.times, b.times)
    for key_id, active, silent in ((1, 0.5, 0.25), (0, 0.3, 0.7),
                                   (2, 1.0, 1.0)):
        for a, b in zip(jp, tp):
            _same_chunk(jrec.silence_key(a, key_id, active, silent),
                        trec.silence_key(b, key_id, active, silent))
    assert not bool(trec.silence_key(tp[1], 1, 0.5, 0.25).mask.all())
    with pytest.raises(ValueError, match="> 0"):
        trec.silence_key(tp[0], 1, 0.0, 1.0)


def test_silence_key_phase_is_fmod_not_remainder():
    """A time whose quotient by the period rounds up: ``fmod`` gives the
    exact phase, ``torch.remainder`` rounds to the other side."""
    c = trec.TimestampedChunk(
        values=torch.zeros(3), stratum_ids=torch.zeros(3, dtype=torch.int32),
        times=torch.tensor([0.69999999, 2.0999999, 5.5999994]),
        mask=torch.ones(3, dtype=torch.bool))
    j = jrec.TimestampedChunk(values=jnp.zeros(3),
                              stratum_ids=jnp.zeros(3, jnp.int32),
                              times=jnp.asarray(c.times.numpy()),
                              mask=jnp.ones(3, bool))
    _same_chunk(jrec.silence_key(j, 0, 0.5, 0.2),
                trec.silence_key(c, 0, 0.5, 0.2))


# ---------------------------------------------------------------------------
# ReplayableStream and MeteredStream.
# ---------------------------------------------------------------------------

def _streams(num_shards=1, disorder=0.3, key_gaps=((1, 0.5, 0.25),),
             seed=7, name="GaussianSource"):
    js, ts = _sources(name)
    kw = dict(chunk_size=64, rate=512.0, num_shards=num_shards,
              disorder=disorder, disorder_seed=5, key_gaps=key_gaps)
    return (jreplay.ReplayableStream(jstream.StreamAggregator(js, seed=seed),
                                     **kw),
            treplay.ReplayableStream(
                tstream.StreamAggregator(ts, seed=seed, device="cpu"), **kw))


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("disorder,key_gaps", [
    (0.0, ()), (0.3, ()), (0.3, ((1, 0.5, 0.25),)),
    (0.2, ((0, 0.3, 0.1), (2, 0.05, 0.05)))])
def test_replayable_stream_chunk_at_bitwise(num_shards, disorder, key_gaps):
    js, ts = _streams(num_shards, disorder, key_gaps)
    assert js.span == ts.span
    for e in (0, 1, 5, 17):
        _same_chunk(js.chunk_at(e), ts.chunk_at(e))


def test_replayable_stream_range_prefix_and_purity():
    _, ts = _streams()
    full = ts.prefix(12)
    again = treplay.ReplayableStream(
        tstream.StreamAggregator(tstream.GaussianSource(), seed=7,
                                 device="cpu"), chunk_size=64, rate=512.0,
        disorder=0.3, disorder_seed=5, key_gaps=((1, 0.5, 0.25),))
    for a, b in zip(full[4:], again.range(4, 12)):
        for f in ("values", "stratum_ids", "times", "mask"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert not bool(full[5].mask.all())       # the key gap silenced items


@pytest.mark.parametrize("num_shards", [1, 4])
def test_metered_stream_matches_the_reference(num_shards):
    js, ts = _streams(num_shards)
    jm, tm = jreplay.MeteredStream(js.prefix(6)), treplay.MeteredStream(
        ts.prefix(6))
    assert len(list(jm)) == len(list(tm)) == 6
    assert jm.summary() == tm.summary()
    assert tm.chunks == 6 and tm.items == jm.items
    assert (tm.min_time, tm.max_time) == (jm.min_time, jm.max_time)


def test_metered_stream_empty_and_all_masked():
    tm = treplay.MeteredStream([])
    list(tm)
    assert tm.summary() == {"chunks": 0, "items": 0, "event_span": 0.0}
    _, ts = _streams(disorder=0.0, key_gaps=())
    c = ts.chunk_at(0)
    c.mask[:] = False
    tm = treplay.MeteredStream([c])
    list(tm)
    assert tm.summary() == {"chunks": 1, "items": 0, "event_span": 0.0}


def test_measure_window_program_and_saturation_search():
    calls = []

    def make_runner(items):
        def run(e):
            calls.append((items, e))
            return {"x": torch.ones(items)}
        return run
    res = treplay.measure_window_program(make_runner(100), 100, warmup=1,
                                         windows=3)
    assert res.windows == 3 and res.items_per_sec > 0
    assert [e for _, e in calls] == [0, 1, 2, 3]
    best = treplay.saturation_search(make_runner, start_items=1000,
                                     max_items=8000, latency_slo_sec=60.0)
    assert best.items_per_sec > 0 and best.windows == 3
    slow = treplay.saturation_search(make_runner, start_items=1000,
                                     max_items=8000, latency_slo_sec=0.0)
    assert slow.windows == 3


# ---------------------------------------------------------------------------
# skewed, Prefetcher, the token window (mirroring tests/test_stream.py).
# ---------------------------------------------------------------------------

def test_skewed_normalizes_and_rejects():
    src = tstream.skewed(tstream.GaussianSource(), (2.0, 1.0, 1.0))
    np.testing.assert_allclose(src.mix, (0.5, 0.25, 0.25))
    g = tstream.GaussianSource()
    for mix, msg in (((0.5, -0.1, 0.6), "nonnegative"),
                     ((0.5, 0.5), "strata"),
                     ((0.0, 0.0, 0.0), "positive total"),
                     ((float("nan"), 0.5, 0.5), "finite"),
                     ((float("inf"), 0.5, 0.5), "finite")):
        with pytest.raises(ValueError, match=msg):
            tstream.skewed(g, mix)
        with pytest.raises(ValueError, match=msg):
            jstream.skewed(jstream.GaussianSource(), mix)


def test_skewed_zero_entry_and_mixture():
    src = tstream.skewed(tstream.GaussianSource(), (0.5, 0.5, 0.0))
    c = src.chunk(prng.PRNGKey(0), 10_000)
    assert int((c.stratum_ids == 2).sum()) == 0
    src = tstream.skewed(tstream.GaussianSource(), (0.8, 0.19, 0.01))
    c = src.chunk(prng.PRNGKey(0), 100_000)
    frac = np.bincount(c.stratum_ids.numpy(), minlength=3) / 100_000
    np.testing.assert_allclose(frac, [0.8, 0.19, 0.01], atol=0.01)


@pytest.mark.parametrize("vocab,domains", [(100, 4), (1000, 7)])
def test_token_window_bitwise(vocab, domains):
    js = jpipe.TokenWindowSpec(16, 32, domains, vocab)
    ts = tpipe.TokenWindowSpec(16, 32, domains, vocab)
    jt, jd = jpipe.synthetic_token_window(js, 7, seed=2)
    tt, td = tpipe.synthetic_token_window(ts, 7, seed=2, device="cpu")
    _bits(jt, tt)
    _bits(jd, td)
    t2, _ = tpipe.synthetic_token_window(ts, 7, seed=2, device="cpu")
    assert torch.equal(tt, t2) and tt.shape == (16, 32)


def test_stream_windows_are_interval_chunks():
    agg = tstream.StreamAggregator(tstream.NetflowSource(), seed=1,
                                   device="cpu")
    wins = list(tpipe.stream_windows(agg, 64, 3, start_epoch=5))
    assert [e for e, _ in wins] == [5, 6, 7]
    assert torch.equal(wins[1][1].values, agg.interval_chunk(6, 64).values)


def test_prefetcher_ordering_and_cursor():
    spec = tpipe.TokenWindowSpec(8, 16, 4, 100)
    pf = tpipe.Prefetcher(
        lambda e: tpipe.synthetic_token_window(spec, e, device="cpu"),
        depth=2)
    epochs = [pf.next()[0] for _ in range(5)]
    assert epochs == [0, 1, 2, 3, 4]
    assert pf.cursor >= 5
    assert pf.close(timeout=30)


def test_prefetcher_background_error_surfaces_on_next():
    def fetch(e):
        if e == 2:
            raise RuntimeError("boom at epoch 2")
        return e * 10

    pf = tpipe.Prefetcher(fetch, depth=2)
    assert pf.next() == (0, 0)
    with pytest.raises(RuntimeError, match="epoch 2"):
        for _ in range(5):
            epoch, _ = pf.next()
            assert epoch == 1


def test_prefetcher_retries_failed_epoch():
    failures = {"left": 1}
    lock = threading.Lock()

    def fetch(e):
        with lock:
            if e == 2 and failures["left"] > 0:
                failures["left"] -= 1
                raise RuntimeError("transient")
        return e * 10

    pf = tpipe.Prefetcher(fetch, depth=2)
    seen = []
    for _ in range(20):
        if len(seen) == 5:
            break
        try:
            seen.append(pf.next())
        except RuntimeError:
            continue
    assert seen == [(0, 0), (1, 10), (2, 20), (3, 30), (4, 40)]


# ---------------------------------------------------------------------------
# A whole replayed run.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ingest", ["fused", "onekernel"])
@pytest.mark.parametrize("emission", ["cadence", "watermark"])
def test_whole_run_on_each_packages_own_stream(ingest, emission):
    """Each package's ``PipelinedExecutor`` on its own
    ``ReplayableStream`` (disorder 0.3, W = 1, 24 chunks): emissions (the
    schedule, watermark counts and capacities bit for bit, answers within
    the executors' parity rtol) and the final state (slot table, counts,
    capacities, watermark, obs counter rows, ring values and mask) bit
    for bit."""
    kw = dict(num_strata=3, capacity=64, num_intervals=4, interval_span=0.5,
              allowed_lateness=0.25, emit_every=4, ingest=ingest,
              emission=emission)
    js, ts = _streams(disorder=0.3, key_gaps=())
    je = jex.PipelinedExecutor(jex.RuntimeConfig(**kw),
                               linear_registry(jregistry),
                               jax.random.PRNGKey(4))
    te = tex.PipelinedExecutor(tex.RuntimeConfig(**kw), linear_registry(),
                               prng.PRNGKey(4), device="cpu")
    jems, tems = je.run(js.prefix(24)), te.run(ts.prefix(24))
    assert tems and sum(e.late for e in tems) + sum(
        e.dropped for e in tems) > 0
    _assert_same_run(je, te, jems, tems)
