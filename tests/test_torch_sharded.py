"""The port's sharded executors on ``placement="vmap"`` against the
reference's, on the CPU.

Every state leaf carries a leading ``[W]`` shard axis. Both packages run
the same numpy-made ``[W, M]`` chunks: every shard row on the same
event-time ramp (``stamp_sharded``'s contract), some items shifted back
(late or dropped), some masked out. Bitwise: every emission's integer
fields, watermark, Σ-over-shards capacity and ``interval``, and every
final state leaf through ``convert``. Within ``test_torch_runtime``'s
rtol: the linear answers and widths. The nonlinear registry keeps
``test_torch_registry``'s tolerances, with the ring's per-shard capacity
a power of two (its HT weights dyadic).
"""
import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import window as jwin
from repro.obs import export as jobx
from repro.obs import metrics as jobm
from repro.runtime import controller as jctl
from repro.runtime import executor as jex
from repro.runtime import registry as jreg
from repro_torch import prng
from repro_torch.core import window as twin
from repro_torch.kernels import ops
from repro_torch.obs import EventLog, Telemetry
from repro_torch.obs import export as obx
from repro_torch.obs import metrics as obm
from repro_torch.runtime import controller as tctl
from repro_torch.runtime import executor as tex
from repro_torch.runtime import records
from test_torch_executors import _assert_same_run
from test_torch_runtime import (_assert_emissions, _assert_state_bitwise,
                                _jchunk, _registries, _tchunk)

INGESTS = ("fused", "masked", "onekernel")
MODES = ("pipelined", "batched")
EMISSIONS = ("cadence", "watermark")


def sharded_kw(w, **kw):
    base = dict(num_strata=3, capacity=16, num_intervals=3,
                interval_span=1.0, allowed_lateness=0.5, emit_every=4,
                batch_chunks=4, num_shards=w)
    base.update(kw)
    return base


def sharded_chunks(seed, n, w, m=64, num_strata=3, span=1.0, disorder=0.3):
    """numpy ``[W, M]`` chunks covering a quarter interval each: every
    row on the same ramp, a ``disorder`` share of the items shifted back
    by up to 1.5 intervals, ~5% masked out."""
    rng = np.random.default_rng(seed)
    mus = np.resize(np.array([10.0, 100.0, 1000.0, 50.0]), num_strata)
    out = []
    for e in range(n):
        sid = rng.integers(0, num_strata, (w, m)).astype(np.int32)
        vals = (mus[sid] * (1.0 + 0.2 * rng.standard_normal((w, m)))
                ).astype(np.float32)
        t = np.broadcast_to((e * m + np.arange(m)) * (span / (4 * m)),
                            (w, m))
        shift = ((rng.random((w, m)) < disorder) * rng.random((w, m))
                 * 1.5 * span)
        t = np.maximum(t - shift, 0.0).astype(np.float32)
        out.append((vals, sid, t, rng.random((w, m)) > 0.05))
    return out


def executors(mode, kw, seed=7, jregistry=None, tregistry=None):
    if jregistry is None:
        jregistry, tregistry = _registries()
    jcls = jex.PipelinedExecutor if mode == "pipelined" else \
        jex.BatchedExecutor
    tcls = tex.PipelinedExecutor if mode == "pipelined" else \
        tex.BatchedExecutor
    return (jcls(jex.RuntimeConfig(**kw), jregistry,
                 jax.random.PRNGKey(seed)),
            tcls(tex.RuntimeConfig(**kw), tregistry, prng.PRNGKey(seed),
                 device="cpu"))


# W = 2 runs the ordered stream, W = 4 the disordered one, on every path.
CASES = [(w, mode, ingest, emission, 0.0 if w == 2 else 0.3)
         for w, mode, ingest, emission in itertools.product(
             (2, 4), MODES, INGESTS, EMISSIONS)]


@functools.lru_cache(maxsize=None)
def reference_run(w, mode, emission, disorder):
    """The reference's run of one case's stream, with its fused ingest:
    the oracle of all three of the port's ingests, since the reference's
    own tests hold its fused, masked and onekernel ingests bit for bit
    equal. So each stream and executor runs the reference once."""
    je, _ = executors(mode, sharded_kw(w, emission=emission))
    chunks = sharded_chunks(3, 12, w, disorder=disorder)
    return je, chunks, je.run(_jchunk(c) for c in chunks)


@pytest.mark.parametrize("w,mode,ingest,emission,disorder", CASES)
def test_vmap_placement_bitwise_against_reference(w, mode, ingest, emission,
                                                  disorder):
    je, chunks, jems = reference_run(w, mode, emission, disorder)
    _, te = executors(mode, sharded_kw(w, ingest=ingest, emission=emission))
    tems = te.run(_tchunk(c) for c in chunks)
    _assert_same_run(je, te, jems, tems)
    assert tems and te.state.window.intervals.values.shape == (w, 3, 3,
                                                               16 // w)
    if disorder:
        assert tems[-1].late > 0 and tems[-1].dropped > 0
    if emission == "watermark":
        assert [e.interval for e in tems] == list(range(len(tems)))


def test_disordered_w2_and_ordered_w4_match_reference():
    """The other two disorder cells, on the paths with most state: W = 2
    batched onekernel on the watermark over the disordered stream, W = 4
    pipelined masked on cadence over the ordered one."""
    for w, mode, ingest, emission, disorder in (
            (2, "batched", "onekernel", "watermark", 0.3),
            (4, "pipelined", "masked", "cadence", 0.0)):
        kw = sharded_kw(w, ingest=ingest, emission=emission)
        chunks = sharded_chunks(4, 12, w, disorder=disorder)
        je, te = executors(mode, kw)
        _assert_same_run(je, te, je.run(_jchunk(c) for c in chunks),
                         te.run(_tchunk(c) for c in chunks))


def test_sharded_state_matches_reference_init():
    """A fresh W = 4 state: per-shard keys ``split(key, 4)``, per-shard
    capacity ``ceil(N / 4)``, ``N_max`` the per-shard capacity."""
    kw = sharded_kw(4, capacity=17)
    _assert_state_bitwise(
        jex.init_state(jex.RuntimeConfig(**kw), jax.random.PRNGKey(3)),
        tex.init_state(tex.RuntimeConfig(**kw), prng.PRNGKey(3), "cpu"))
    state = tex.init_state(tex.RuntimeConfig(**kw), prng.PRNGKey(3), "cpu")
    assert state.window.intervals.values.shape == (4, 3, 3, 5)
    assert state.ctrl.capacity.tolist() == [[5] * 3] * 4


def test_merged_view_of_a_sharded_ring_is_a_view():
    """The emission's ``[W·K·S, N]`` merged view shares the ring's memory
    and equals the reference's vmapped views, concatenated."""
    kw = sharded_kw(4, ingest="onekernel")
    je, te = executors("pipelined", kw)
    for c in sharded_chunks(5, 6, 4):
        je.push(_jchunk(c))
        te.push(_tchunk(c))
    tv = twin.sample_view(te.state.window)
    assert tv.values.data_ptr() == \
        te.state.window.intervals.values.data_ptr()
    jv = jax.vmap(jwin.sample_view)(je.state.window)
    for f in ("values", "counts", "taken"):
        a = np.asarray(getattr(jv, f))
        np.testing.assert_array_equal(
            a.reshape((-1,) + a.shape[2:]), getattr(tv, f).numpy())


def test_nonlinear_registry_sharded_matches_reference():
    """Every kind under every window at W = 4 (pipelined onekernel on
    cadence): the same emissions and state bit for bit, the same
    heavy-hitter keys, answers within the registry's tolerances."""
    from test_torch_cuda import nonlinear_registry
    from test_torch_registry import assert_results_close
    kw = sharded_kw(4, ingest="onekernel", max_capacity=16, capacity=64)
    chunks = sharded_chunks(6, 12, 4)
    for c in chunks:
        c[0][...] = np.floor(c[0] / 10.0) * 10.0        # repeated keys
    je, te = executors("pipelined", kw, jregistry=nonlinear_registry(jreg),
                       tregistry=nonlinear_registry())
    jems = je.run(_jchunk(c) for c in chunks)
    tems = te.run(_tchunk(c) for c in chunks)
    assert len(jems) == len(tems) > 0
    for a, b in zip(jems, tems):
        for f in ("index", "interval", "watermark", "open_interval",
                  "on_time", "late", "dropped", "items"):
            assert getattr(a, f) == getattr(b, f), (a.index, f)
        np.testing.assert_array_equal(a.capacity, b.capacity)
        assert_results_close(a.results, b.results)
    _assert_state_bitwise(je.state, te.state)


@pytest.mark.parametrize("ingest", INGESTS)
def test_ad_hoc_query_sharded_matches_reference(ingest):
    je, te = executors("pipelined", sharded_kw(4, ingest=ingest,
                                               emit_every=100))
    for c in sharded_chunks(7, 5, 4):
        je.push(_jchunk(c))
        te.push(_tchunk(c))
    jq, tq = je.query(), te.query()
    assert jq.keys() == tq.keys() and not te.emissions
    for name in jq:
        np.testing.assert_allclose(float(tq[name].value),
                                   float(jq[name].value), rtol=1e-5)
        np.testing.assert_allclose(float(tq[name].error_bound()),
                                   float(jq[name].error_bound()), rtol=1e-4)


@pytest.mark.parametrize("ingest", INGESTS)
def test_threefry_calls_per_chunk_do_not_grow_with_shards(ingest,
                                                          monkeypatch):
    """The draws of W shards are one hash over ``[W, M]`` words: a W = 4
    chunk calls ``prng.threefry2x32`` as often as a W = 1 chunk."""
    calls = []
    hash_ = prng.threefry2x32

    def counted(*a):
        calls.append(1)
        return hash_(*a)
    monkeypatch.setattr(prng, "threefry2x32", counted)
    per_chunk = {}
    for w in (1, 4):
        kw = sharded_kw(w, ingest=ingest, emit_every=100)
        ex = tex.PipelinedExecutor(tex.RuntimeConfig(**kw),
                                   _registries()[1], prng.PRNGKey(1),
                                   device="cpu")
        chunks = sharded_chunks(8, 3, w)
        calls.clear()
        for c in chunks:
            ex.push(_tchunk(tuple(a[0] for a in c) if w == 1 else c))
        per_chunk[w] = len(calls) / len(chunks)
    assert per_chunk[1] == per_chunk[4] > 0


@pytest.mark.parametrize("ingest,folds,one_shots", [
    ("fused", 1, 0), ("masked", 1, 0), ("onekernel", 0, 1)])
def test_kernel_calls_per_sharded_chunk(ingest, folds, one_shots,
                                        monkeypatch):
    """Per W = 4 chunk (K = 3): ``fused`` calls the fold once over the
    ``W·K·S`` cells, ``masked`` once batched over its ``W·K`` folds (the
    reference's nested vmap of its kernel), ``onekernel`` the one-shot
    ingest once, batched over the W shards (the reference's vmapped
    kernel call)."""
    calls = {"fold": 0, "one_shot": 0}
    fold, one_shot = ops.reservoir_fold, ops.one_shot_ingest

    def fold_counted(*a, **kw):
        calls["fold"] += 1
        return fold(*a, **kw)

    def one_shot_counted(*a, **kw):
        calls["one_shot"] += 1
        return one_shot(*a, **kw)
    monkeypatch.setattr(ops, "reservoir_fold", fold_counted)
    monkeypatch.setattr(ops, "one_shot_ingest", one_shot_counted)
    ex = tex.PipelinedExecutor(
        tex.RuntimeConfig(**sharded_kw(4, ingest=ingest, emit_every=100)),
        _registries()[1], prng.PRNGKey(1), device="cpu")
    chunks = sharded_chunks(8, 3, 4)
    for c in chunks:
        ex.push(_tchunk(c))
    assert calls == {"fold": folds * len(chunks),
                     "one_shot": one_shots * len(chunks)}


def test_fused_cells_over_the_fold_limit_raise():
    """``W·K·S`` cells past the fold kernel's small-key 1024 (4 x 3 x 100
    = 1200) run: the port's fused ingest bit for bit the reference's over
    a few chunks. Only the int32 ring index is refused by name before any
    state exists."""
    je, te = executors("pipelined", sharded_kw(4, num_strata=100,
                                               emit_every=100))
    for c in sharded_chunks(13, 4, 4, m=256, num_strata=100):
        je.push(_jchunk(c))
        te.push(_tchunk(c))
    _assert_state_bitwise(je.state, te.state)
    assert te.state.window.intervals.values.shape == (4, 3, 100, 4)
    big = sharded_kw(2, num_strata=8, capacity=2 ** 27)
    with pytest.raises(tex.UnsupportedConfigError, match="int32"):
        tex.init_state(tex.RuntimeConfig(**big), prng.PRNGKey(0), "cpu")


@functools.lru_cache(maxsize=None)
def stats_limit_reference():
    """The reference's run of the 516-cell case (pipelined fused, one
    emission), the oracle of every vmap pair below."""
    je, _ = executors("pipelined", sharded_kw(4, num_strata=43))
    chunks = sharded_chunks(14, 4, 4, m=128, num_strata=43)
    return je, chunks, je.run(_jchunk(c) for c in chunks)


@pytest.mark.parametrize("ingest,placement", [
    ("fused", "vmap"), ("masked", "vmap"), ("onekernel", "vmap"),
    ("onekernel", "mesh")])
def test_cells_over_the_stats_limit_run(ingest, placement):
    """Each emission's stats call takes the merged view's ``W·K·S`` rows
    as its strata, on a mesh rank too. Past the stats kernel's one-launch
    512 (4 x 3 x 43 = 516 cells) every ingest's state is taken at init; on
    the vmap placement a push of four chunks and its emission match the
    reference's, the state bit for bit."""
    shard = 0 if placement == "mesh" else None
    kw = sharded_kw(4, num_strata=43, ingest=ingest, placement=placement)
    state = tex.init_state(tex.RuntimeConfig(**kw), prng.PRNGKey(0), "cpu",
                           shard=shard)
    assert state.window.intervals.values.shape[-3:-1] == (3, 43)
    if placement == "mesh":
        return
    je, chunks, jems = stats_limit_reference()
    _, te = executors("pipelined", kw)
    tems = te.run(_tchunk(c) for c in chunks)
    assert len(tems) == 1
    _assert_same_run(je, te, jems, tems)


def test_stamp_sharded_matches_reference():
    from repro.runtime import records as jrec
    from repro.stream.sources import StreamChunk
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(4, 33)).astype(np.float32)
    sid = rng.integers(0, 3, (4, 33)).astype(np.int32)
    j = jrec.stamp_sharded(StreamChunk(values=vals, stratum_ids=sid), 2.5,
                           64.0)
    t = records.stamp_sharded(torch.from_numpy(vals), torch.from_numpy(sid),
                              2.5, 64.0)
    for f in ("values", "stratum_ids", "times", "mask"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_telemetry_exports_sharded_match_reference():
    """At W = 4: ``run_meta`` names the shards; the counters, exports and
    Prometheus text sum over the shards as the reference's do; the
    ``controller`` event's capacity is the Σ over shards."""
    kw = sharded_kw(4, ingest="fused", emission="watermark")
    chunks = sharded_chunks(9, 12, 4)
    je, te = executors("pipelined", kw)
    log = EventLog()
    te.attach_telemetry(Telemetry(log))
    jems = je.run(_jchunk(c) for c in chunks)
    ems = te.run(_tchunk(c) for c in chunks)
    assert log.of_type("run_meta")[0]["num_shards"] == 4
    jc, tc = jobm.counters(je.state.metrics), obm.counters(te.state.metrics)
    for k in jc:
        np.testing.assert_array_equal(np.asarray(jc[k]), tc[k])
    assert tc["items"] == sum(c[3].sum() for c in chunks)
    assert obm.export(te.state.metrics) == jobm.export(je.state.metrics)
    assert obx.prometheus_text(te, Telemetry()) == \
        jobx.prometheus_text(je, jobm.Telemetry())
    tele = tctl.telemetry(te.state.ctrl)
    assert tele == {**jctl.telemetry(je.state.ctrl),
                    "pressure": tele["pressure"],
                    "latency_ema": tele["latency_ema"]}
    events = log.of_type("controller")
    assert len(events) == len(ems) > 0
    assert events[-1]["capacity"] == ems[-1].capacity.tolist() == \
        np.asarray(jems[-1].capacity).tolist() == tele["capacity"]
