"""The port's pipelined executor against the reference's, on the CPU.

Both run the same numpy-made disordered chunks (some items late, some
dropped). Bitwise: every emission's integer fields, capacity and
watermark, the obs counters, and the final ring, counts, capacities and
keys. Within rtol: answers (1e-5) and widths (1e-4, the s2
cancellation). The same holds from a state converted mid-stream.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import executor as jex
from repro.runtime import registry as jreg
from repro.runtime.records import TimestampedChunk as JChunk
from repro_torch import prng
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from repro_torch.runtime.records import TimestampedChunk as TChunk

VALUE_RTOL, WIDTH_RTOL = 1e-5, 1e-4

CONFIGS = {
    "k3": dict(num_strata=3, capacity=16, num_intervals=3,
               interval_span=1.0, allowed_lateness=0.5, emit_every=4,
               max_capacity=32),
    "k2_span5": dict(num_strata=4, capacity=24, num_intervals=2,
                     interval_span=5.0, allowed_lateness=2.0, emit_every=3),
}


def _chunks(seed, n, m, num_strata, span):
    """Disordered chunks covering a quarter interval each: ~30% of items
    shifted back by up to 1.5 intervals, ~5% masked out."""
    rng = np.random.default_rng(seed)
    mus = np.resize(np.array([10.0, 100.0, 1000.0, 50.0]), num_strata)
    out = []
    for e in range(n):
        sid = rng.integers(0, num_strata, m).astype(np.int32)
        vals = (mus[sid] * (1.0 + 0.2 * rng.standard_normal(m))).astype(
            np.float32)
        t = (e * m + np.arange(m)) * (span / (4 * m))
        shift = (rng.random(m) < 0.3) * rng.random(m) * 1.5 * span
        t = np.maximum(t - shift, 0.0).astype(np.float32)
        out.append((vals, sid, t, rng.random(m) > 0.05))
    return out


def _jchunk(c):
    return JChunk(*(jnp.asarray(a) for a in c))


def _tchunk(c):
    return TChunk(*(torch.from_numpy(a) for a in c))


def _registries():
    big = 500.0
    j = (jreg.QueryRegistry().register("total", "sum")
         .register("avg", "mean")
         .register("big", "count", predicate=lambda x: x > big))
    t = (treg.QueryRegistry().register("total", "sum")
         .register("avg", "mean")
         .register("big", "count", predicate=lambda x: x > big))
    return j, t


def jax_state_dict(state) -> dict:
    """The reference's RuntimeState as the nested numpy dict the port's
    ``convert`` takes."""
    def conv(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: conv(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        return np.asarray(obj)
    return conv(jax.device_get(state))


def _assert_state_bitwise(jstate, tstate):
    j, t = jax_state_dict(jstate), convert.state_to_numpy(tstate)
    # The latency EMA is wall-clock feedback: the two runs differ.
    for leaf in ("latency_ema", "pressure"):
        j["ctrl"].pop(leaf), t["ctrl"].pop(leaf)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
    walk(j, t, "state")


def _assert_emissions(jems, tems):
    assert len(jems) == len(tems)
    for a, b in zip(jems, tems):
        for f in ("index", "watermark", "open_interval", "on_time", "late",
                  "dropped", "items"):
            assert getattr(a, f) == getattr(b, f), (a.index, f)
        np.testing.assert_array_equal(a.capacity, b.capacity)
        assert a.results.keys() == b.results.keys()
        for name in a.results:
            ja, tb = a.results[name], b.results[name]
            np.testing.assert_allclose(float(tb.value), float(ja.value),
                                       rtol=VALUE_RTOL)
            np.testing.assert_allclose(float(tb.error_bound()),
                                       float(ja.error_bound()),
                                       rtol=WIDTH_RTOL)


def _run_both(cfg_kw, seed=7):
    jr, tr = _registries()
    je = jex.PipelinedExecutor(jex.RuntimeConfig(**cfg_kw), jr,
                               jax.random.PRNGKey(seed))
    te = tex.PipelinedExecutor(tex.RuntimeConfig(**cfg_kw), tr,
                               prng.PRNGKey(seed), device="cpu")
    return je, te


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipelined_executor_bitwise_from_fresh(name):
    cfg_kw = CONFIGS[name]
    chunks = _chunks(3, 14, 240, cfg_kw["num_strata"],
                     cfg_kw["interval_span"])
    je, te = _run_both(cfg_kw)
    jems = je.run(_jchunk(c) for c in chunks)
    tems = te.run(_tchunk(c) for c in chunks)
    _assert_emissions(jems, tems)
    _assert_state_bitwise(je.state, te.state)
    last = tems[-1]
    assert last.late > 0 and last.dropped > 0     # both paths exercised
    m = te.state.metrics
    assert torch.equal(m.ingested, m.accepted + m.dropped)
    assert int(m.replaced.sum()) > 0              # replacement phase too
    _assert_window_helpers(je.state.window, te.state.window)


def _assert_window_helpers(jw, tw):
    """The merged view, liveness, activity and restriction on the final
    ring (bitwise)."""
    from repro.core import window as jwin
    from repro_torch.core import window as twin
    jv, tv = jwin.sample_view(jw), twin.sample_view(tw)
    for f in ("values", "counts", "taken"):
        np.testing.assert_array_equal(np.asarray(getattr(jv, f)),
                                      getattr(tv, f).numpy())
    np.testing.assert_array_equal(np.asarray(jv.slot_mask()),
                                  tv.slot_mask().numpy())
    np.testing.assert_array_equal(np.asarray(jv.weights()),
                                  tv.weights().numpy())
    np.testing.assert_array_equal(np.asarray(jwin._live_mask(jw)),
                                  twin._live_mask(tw).numpy())
    np.testing.assert_array_equal(np.asarray(jwin.activity_mask(jw)),
                                  twin.activity_mask(tw).numpy())
    cells = np.arange(jv.counts.shape[0]) % 2 == 0
    jr = jwin.restrict_view(jv, jnp.asarray(cells))
    tr = twin.restrict_view(tv, torch.from_numpy(cells))
    for f in ("counts", "taken"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_carry_over_from_converted_state(name):
    """Run the reference for k chunks (an emission boundary), convert its
    state, continue both on the same suffix."""
    cfg_kw = CONFIGS[name]
    k = 2 * cfg_kw["emit_every"]
    chunks = _chunks(5, 13, 200, cfg_kw["num_strata"],
                     cfg_kw["interval_span"])
    je, te = _run_both(cfg_kw, seed=11)
    for c in chunks[:k]:
        je.push(_jchunk(c))
    d = jax_state_dict(je.state)
    state = convert.state_from_numpy(d, "cpu")
    back = convert.state_to_numpy(state)
    assert jax.tree.map(lambda a, b: a.tobytes() == b.tobytes(), d, back) \
        == jax.tree.map(lambda a: True, d)
    te.resume(state, chunks_pushed=k, emissions_done=len(je.emissions))
    done = len(je.emissions)
    for c in chunks[k:]:
        je.push(_jchunk(c))
        te.push(_tchunk(c))
    _assert_emissions(je.finalize()[done:], te.finalize())
    _assert_state_bitwise(je.state, te.state)


def test_config_converts_field_by_field():
    from repro.core import adaptive as jad
    from repro.runtime import controller as jctl
    jcfg = jex.RuntimeConfig(
        num_strata=3, capacity=64, num_intervals=2, interval_span=5.0,
        controller=jctl.ControllerConfig(
            budget=jad.accuracy_budget(2.5, 0.95, max_per_stratum=512),
            latency_budget_s=0.1))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.interval_span == 5.0 and tcfg.num_intervals == 2
    b = tcfg.controller.budget
    assert (b.target_half_width, b.z, b.min_per_stratum,
            b.max_per_stratum) == (2.5, 2.0, 8, 512)
    assert tcfg.controller.latency_budget_s == 0.1
    assert convert.config_from_dict(convert.config_to_dict(tcfg)) == tcfg
    state = tex.init_state(tcfg, prng.PRNGKey(0), device="cpu")
    assert state.window.intervals.values.shape == (2, 3, 512)


@pytest.mark.parametrize("backend", [None, "auto", "jnp", "pallas"])
def test_config_backend_field_converts(backend):
    """The reference's fold choice converts; only the platform's choice
    (None | "auto") runs, since the port picks the fold by device."""
    jcfg = jex.RuntimeConfig(num_strata=3, capacity=8, backend=backend)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.backend == backend
    if backend in (None, "auto"):
        tex.init_state(tcfg, prng.PRNGKey(0), device="cpu")
    else:
        with pytest.raises(tex.UnsupportedConfigError, match="by device"):
            tex.init_state(tcfg, prng.PRNGKey(0), device="cpu")


def test_config_backend_unknown_value_raises():
    cfg = tex.RuntimeConfig(num_strata=3, capacity=8, backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        tex.init_state(cfg, prng.PRNGKey(0), device="cpu")


def test_push_never_reads_back_a_device_value(monkeypatch):
    cfg_kw = dict(CONFIGS["k3"], emit_every=1000)
    chunks = _chunks(9, 6, 128, 3, 1.0)
    _, tr = _registries()
    te = tex.PipelinedExecutor(tex.RuntimeConfig(**cfg_kw), tr,
                               prng.PRNGKey(0), device="cpu")

    def refuse(*_):
        raise AssertionError("push read a tensor value back to the host")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for c in chunks:
        te.push(_tchunk(c))
    monkeypatch.undo()
    assert te.chunks_pushed == 6 and not te.emissions
    assert set(te.query()) == {"total", "avg", "big"}
    assert len(te.finalize()) == 1

    # Watermark emission reads back exactly one value per push, the
    # chunk's max event time for the frontier mirror (the four chunks
    # close no interval, so no emission reads the state either).
    te = tex.PipelinedExecutor(
        tex.RuntimeConfig(**dict(cfg_kw, emission="watermark",
                                 ingest="onekernel")),
        tr, prng.PRNGKey(0), device="cpu")
    reads = []
    item = torch.Tensor.item

    def counted_item(t):
        reads.append(t.shape)
        return item(t)
    for name in ("tolist", "__bool__", "__int__", "__float__", "numpy",
                 "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.Tensor, "item", counted_item)
    for c in chunks[:4]:
        te.push(_tchunk(c))
    monkeypatch.undo()
    assert reads == [torch.Size([])] * 4 and not te.emissions


@pytest.mark.parametrize("change,exc,error", [
    # Item 7b ported checkpoints on the mesh: the case keeps its id and
    # checks that a mesh executor takes a checkpointer and refuses only
    # the missing process group.
    pytest.param(dict(num_shards=2, placement="mesh"), ValueError,
                 "init_process_group", id="change0-item 7b")])
def test_unported_configurations_raise(change, exc, error):
    """What the port refuses, by name: a mesh executor, which takes a
    checkpointer, without an initialized process group."""
    from repro_torch.runtime.checkpoint import Checkpointer
    cfg = tex.RuntimeConfig(**dict(dict(num_strata=3, capacity=8),
                                   **change))
    _, tr = _registries()
    with pytest.raises(exc, match=error):
        tex.PipelinedExecutor(cfg, tr, prng.PRNGKey(0), device="cpu",
                              checkpointer=Checkpointer(every_chunks=2))
    if cfg.placement == "vmap":
        with pytest.raises(tex.UnsupportedConfigError, match=error):
            tex.init_state(cfg, prng.PRNGKey(0), device="cpu")


def test_fused_w4_s100_matches_reference():
    """100 sub-streams on 4 shards with 3 intervals (``W·K·S`` = 1,200
    cells, past the fold kernel's small-key 1,024 and the stats kernel's
    512 rows, which the port once refused at init): a few chunks pushed
    through both packages' pipelined fused executors give the same
    emissions and the same state bit for bit."""
    from test_torch_sharded import sharded_chunks, sharded_kw
    kw = sharded_kw(4, num_strata=100, emit_every=3)
    jr, tr = _registries()
    je = jex.PipelinedExecutor(jex.RuntimeConfig(**kw), jr,
                               jax.random.PRNGKey(5))
    te = tex.PipelinedExecutor(tex.RuntimeConfig(**kw), tr,
                               prng.PRNGKey(5), device="cpu")
    chunks = sharded_chunks(9, 6, 4, m=256, num_strata=100)
    jems = je.run(_jchunk(c) for c in chunks)
    tems = te.run(_tchunk(c) for c in chunks)
    assert len(tems) == 2
    _assert_emissions(jems, tems)
    _assert_state_bitwise(je.state, te.state)


@pytest.mark.parametrize("kind,kw,error", [
    ("count", {}, "needs predicate"),
    ("quantile", {}, "needs qs"),
    ("histogram", {}, "needs edges"),
    ("sum", {"window": "session"}, "needs session_gap"),
    ("mean", {"window": "session", "session_gap": 0.0}, "must be > 0"),
    ("sum", {"window": "per_key", "session_gap": -1.0}, "must be > 0"),
    ("heavy_hitters", {"window": "per_key"}, "only the merged window"),
    ("distinct", {"window": "per_key"}, "only the merged window"),
    ("heavy_hitters", {"window": "session", "session_gap": 1.0},
     "only the merged window"),
    ("median", {}, "unknown query kind"),
    ("sum", {"window": "sliding"}, "unknown window kind")])
def test_standing_query_errors_match_reference(kind, kw, error):
    """The port's ``StandingQuery`` refuses what the reference's refuses,
    with the same message."""
    for reg in (jreg.QueryRegistry(), treg.QueryRegistry()):
        with pytest.raises(ValueError, match=error):
            reg.register("q", kind, **kw)


def test_registry_validation():
    reg = treg.QueryRegistry().register("a", "sum")
    with pytest.raises(ValueError):
        reg.register("a", "mean")
    with pytest.raises(ValueError):
        reg.register("b", "median")
    with pytest.raises(ValueError):
        reg.register("c", "count")
    with pytest.raises(ValueError):
        tex.PipelinedExecutor(tex.RuntimeConfig(num_strata=3, capacity=8),
                              treg.QueryRegistry(), prng.PRNGKey(0),
                              device="cpu")
    tex.PipelinedExecutor(tex.RuntimeConfig(num_strata=3, capacity=8), reg,
                          prng.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="frozen"):
        reg.register("d", "mean")
