"""Both of the port's executors against the reference's, on the CPU, for
every ingest path and both emission modes.

Both run the same numpy-made disordered chunks (``test_torch_runtime``'s
maker: some items late, some dropped). Bitwise: every emission's integer
fields, capacity, watermark and ``interval``, the final ring, counts,
capacities, keys, watermark and obs counters, and the watermark
emission's base key. Within rtol: answers (1e-5) and widths (1e-4)
(``test_torch_resume.py``: the same from a state converted mid-stream).
The controller runs with
its defaults, where the wall-clock latency moves only ``latency_ema`` and
``pressure``, which the state comparison leaves out.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from repro.runtime import executor as jex
from repro_torch import prng
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from test_torch_runtime import (CONFIGS, _assert_emissions,
                                _assert_state_bitwise, _chunks, _jchunk,
                                _registries, _tchunk)

INGESTS = ("fused", "masked", "onekernel")
MODES = ("pipelined", "batched")
EMISSIONS = ("cadence", "watermark")
CASES = list(itertools.product(sorted(CONFIGS), INGESTS, MODES, EMISSIONS))


def _executors(name, ingest, mode, emission, seed):
    kw = dict(CONFIGS[name], ingest=ingest, emission=emission)
    jr, tr = _registries()
    jcls = jex.PipelinedExecutor if mode == "pipelined" else \
        jex.BatchedExecutor
    tcls = tex.PipelinedExecutor if mode == "pipelined" else \
        tex.BatchedExecutor
    je = jcls(jex.RuntimeConfig(**kw), jr, jax.random.PRNGKey(seed))
    te = tcls(tex.RuntimeConfig(**kw), tr, prng.PRNGKey(seed), device="cpu")
    return je, te


def _assert_same_run(je, te, jems, tems):
    _assert_emissions(jems, tems)
    assert [e.interval for e in jems] == [e.interval for e in tems]
    _assert_state_bitwise(je.state, te.state)
    np.testing.assert_array_equal(
        np.asarray(je._emit_base_key).astype(np.int64),
        te._emit_base_key.numpy())


@pytest.mark.parametrize("name,ingest,mode,emission", CASES)
def test_executor_bitwise_from_fresh(name, ingest, mode, emission):
    kw = CONFIGS[name]
    chunks = _chunks(3, 14, 240, kw["num_strata"], kw["interval_span"])
    je, te = _executors(name, ingest, mode, emission, seed=7)
    jems = je.run(_jchunk(c) for c in chunks)
    tems = te.run(_tchunk(c) for c in chunks)
    _assert_same_run(je, te, jems, tems)
    assert tems and tems[-1].late > 0 and tems[-1].dropped > 0
    if emission == "watermark":
        assert [e.interval for e in tems] == list(range(len(tems)))


@pytest.mark.parametrize("emission", EMISSIONS)
def test_batched_equals_pipelined_at_window_boundaries(emission):
    """The port's two executors on one stream, final states bit for bit.
    Cadence: with ``batch_chunks == emit_every`` every flush is an
    emission boundary, so every emission field is the same. Watermark:
    the same intervals close, once each, with the same answers (a closed
    interval takes no more items); the watermark accounting recorded
    beside them is read later by the batched executor."""
    kw = dict(CONFIGS["k3"], ingest="onekernel", emission=emission,
              batch_chunks=CONFIGS["k3"]["emit_every"])
    chunks = [_tchunk(c) for c in _chunks(2, 16, 200, 3, 1.0)]
    runs = []
    for cls in (tex.PipelinedExecutor, tex.BatchedExecutor):
        ex = cls(tex.RuntimeConfig(**kw), _registries()[1], prng.PRNGKey(4),
                 device="cpu")
        runs.append((ex.run(chunks), convert.state_to_numpy(ex.state)))
    (pems, pstate), (bems, bstate) = runs
    assert len(pems) == len(bems) > 0
    for a, b in zip(pems, bems):
        fields = ("index", "interval")
        if emission == "cadence":
            fields += ("watermark", "open_interval", "on_time", "late",
                       "dropped", "items")
        for f in fields:
            assert getattr(a, f) == getattr(b, f), (a.index, f)
        for q in a.results:
            assert float(a.results[q].value) == float(b.results[q].value)
            assert float(a.results[q].variance) == \
                float(b.results[q].variance)
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(pstate[part], bstate[part])


@pytest.mark.parametrize("cls", [tex.PipelinedExecutor,
                                 tex.BatchedExecutor])
def test_watermark_lateness_must_fit_the_ring(cls):
    cfg = tex.RuntimeConfig(num_strata=3, capacity=8, num_intervals=3,
                            interval_span=1.0, allowed_lateness=2.0,
                            emission="watermark")
    with pytest.raises(ValueError, match="allowed_lateness <"):
        cls(cfg, _registries()[1], prng.PRNGKey(0), device="cpu")


def test_watermark_eviction_raises():
    """One chunk moves the frontier across a whole window: the closed
    interval's slot was recycled before it could be emitted."""
    cfg = tex.RuntimeConfig(num_strata=3, capacity=8, num_intervals=3,
                            interval_span=1.0, allowed_lateness=0.5,
                            emission="watermark", ingest="onekernel")
    ex = tex.PipelinedExecutor(cfg, _registries()[1], prng.PRNGKey(0),
                               device="cpu")

    def chunk(t0):
        return _tchunk((np.full(16, 5.0, np.float32),
                        np.zeros(16, np.int32),
                        np.linspace(t0, t0 + 0.2, 16).astype(np.float32),
                        np.ones(16, bool)))
    ex.push(chunk(0.0))
    assert not ex.emissions
    with pytest.raises(RuntimeError, match="left the ring"):
        ex.push(chunk(10.0))


@pytest.mark.parametrize("change,error", [
    (dict(emission="on_close"), "emission mode"),
    (dict(ingest="scan"), "ingest path")])
def test_unknown_modes_raise(change, error):
    cfg = tex.RuntimeConfig(num_strata=3, capacity=8, **change)
    with pytest.raises(ValueError, match=error):
        tex.BatchedExecutor(cfg, _registries()[1], prng.PRNGKey(0),
                            device="cpu")


def test_accuracy_query_must_be_registered():
    cfg = tex.RuntimeConfig(num_strata=3, capacity=8,
                            accuracy_query="missing")
    with pytest.raises(ValueError, match="not registered"):
        tex.BatchedExecutor(cfg, _registries()[1], prng.PRNGKey(0),
                            device="cpu")


def test_config_converts_new_modes():
    for ingest, emission in itertools.product(INGESTS, EMISSIONS):
        jcfg = jex.RuntimeConfig(num_strata=3, capacity=8, ingest=ingest,
                                 emission=emission)
        tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
        assert (tcfg.ingest, tcfg.emission) == (ingest, emission)
        tex.BatchedExecutor(tcfg, _registries()[1], prng.PRNGKey(0),
                            device="cpu")
