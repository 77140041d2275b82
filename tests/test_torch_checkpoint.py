"""Exactly-once recovery of the port's executors, on the CPU.

The port's own crash harness (``crash_and_recover``,
``exactly_once_output``, ``assert_emission_bitwise``) mirrors the
reference's ``tests/harness_crash.py``: run an executor with a cadence
``Checkpointer``, kill it after chunk ``k`` (only the latest payload's
bytes survive), restore an executor built with another key from the
bytes, replay the chunks from ``stream_offset``, and hold the deduped
output and the final state bit for bit against the uninterrupted run.
The chunks are the reference's ``ReplayableStream`` chunks, converted to
torch; the ring's capacity is 64, a power of two, so the quantiles'
cumulative weights are exact.

Against the reference, in both directions: a reference payload restores
into the port and a port payload loads through the reference's
``from_bytes``; each continuation ends in the other package's
uninterrupted state bit for bit, with the same emission schedule,
integer fields and capacities, and answers within the parity tolerances
of ``test_torch_executors.py`` (the two packages' reductions round
differently).
"""
import dataclasses
import functools
import io
import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import adaptive as jad
from repro.runtime import checkpoint as jckp
from repro.runtime import controller as jctl
from repro.runtime import executor as jex
from repro.runtime import registry as jreg
from repro.stream import GaussianSource, ReplayableStream, StreamAggregator
from repro_torch import prng
from repro_torch.core import adaptive as tad
from repro_torch.runtime import checkpoint as ckp
from repro_torch.runtime import controller as tctl
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from repro_torch.runtime import watermark as twmk
from repro_torch.runtime.records import TimestampedChunk as TChunk
from test_torch_executors import _assert_same_run
from test_torch_runtime import _assert_emissions, jax_state_dict

MODES = ("pipelined", "batched")
EMISSIONS = ("cadence", "watermark")
INGESTS = ("fused", "onekernel")
N = 8                                    # chunks per stream
KEY, OTHER_KEY = 0, 999


def _big(x):
    return x > 500.0


def every_kind_registry(module=treg):
    """The reference's every-kind crash-sweep registry."""
    return (module.QueryRegistry()
            .register("total", "sum")
            .register("avg", "mean")
            .register("big", "count", predicate=_big)
            .register("hist", "histogram", edges=(0.0, 100.0, 5000.0, 2e4))
            .register("p", "quantile", qs=(0.5, 0.9), num_replicates=8)
            .register("top", "heavy_hitters", k=4)
            .register("nuniq", "distinct", num_replicates=8))


def watermark_registry(module=treg):
    """The reference's watermark crash-sweep registry (per-key and
    session windows riding along)."""
    return (module.QueryRegistry()
            .register("total", "sum")
            .register("avg", "mean")
            .register("p", "quantile", qs=(0.5, 0.9), num_replicates=8)
            .register("key_sum", "sum", window="per_key")
            .register("sess", "sum", window="session", session_gap=0.75))


def linear_registry(module=treg):
    return (module.QueryRegistry().register("total", "sum")
            .register("avg", "mean").register("big", "count",
                                              predicate=_big))


def cfg_kw(**kw):
    base = dict(num_strata=3, capacity=64, num_intervals=4,
                interval_span=1.0, allowed_lateness=0.5, batch_chunks=2,
                emit_every=2)
    base.update(kw)
    return base


def budget_kw(module, target=0.05, max_per_stratum=64):
    """The accuracy controller in ``module``'s types (reference or
    port)."""
    ad = jad if module is jex else tad
    cc = jctl.ControllerConfig if module is jex else tctl.ControllerConfig
    return dict(capacity=16, accuracy_query="avg", controller=cc(
        budget=ad.accuracy_budget(target, max_per_stratum=max_per_stratum)))


@functools.lru_cache(maxsize=None)
def chunks(seed=3, n=N, chunk_size=128, disorder=0.0, num_shards=1):
    """The reference's replayable chunks and the same chunks in torch
    (``[W, M]`` leaves for ``num_shards`` W > 1)."""
    stream = ReplayableStream(StreamAggregator(GaussianSource(), seed=seed),
                              chunk_size=chunk_size,
                              rate=chunk_size * n / 4.0, disorder=disorder,
                              disorder_seed=9, num_shards=num_shards)
    jchunks = stream.prefix(n)
    tchunks = tuple(TChunk(*(torch.from_numpy(np.array(getattr(c, f)))
                             for f in ("values", "stratum_ids", "times",
                                       "mask")))
                    for c in jchunks)
    return tuple(jchunks), tchunks


def port_executor(mode, cfg, registry, seed, **kw):
    cls = tex.PipelinedExecutor if mode == "pipelined" else \
        tex.BatchedExecutor
    return cls(tex.RuntimeConfig(**cfg), registry, prng.PRNGKey(seed),
               device="cpu", **kw)


def ref_executor(mode, cfg, registry, seed):
    cls = jex.PipelinedExecutor if mode == "pipelined" else \
        jex.BatchedExecutor
    return cls(jex.RuntimeConfig(**cfg), registry, jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# The port's crash harness.
# ---------------------------------------------------------------------------

def crash_and_recover(victim, recovery, stream, crash_after, every_chunks,
                      key):
    """Kill ``victim`` after ``crash_after`` chunks of ``stream``; only the
    latest payload's bytes survive; restore ``recovery`` from them and
    replay the rest. Returns ``(pre_crash, ckpt, recovered)``."""
    victim.reset(key)
    ck = ckp.Checkpointer(every_chunks=every_chunks)
    victim.checkpointer = ck
    ck.save(victim)            # at offset 0: an early crash recovers too
    for c in stream[:crash_after]:
        victim.push(c)
    payload = ck.latest
    victim.checkpointer = None
    ckpt = recovery.restore(payload)
    for c in stream[ckpt.stream_offset:]:
        recovery.push(c)
    return list(victim.emissions), ckpt, recovery.finalize()


def exactly_once_output(pre_crash, ckpt, recovered):
    """What a consumer keeping the first copy per index sees."""
    return pre_crash[:ckpt.emissions_done] + recovered


def results_bits(results) -> dict:
    out = {}
    for name, r in results.items():
        d = {f: a.tobytes() for f, a in convert.results_to_numpy(
            {name: r})[name].items()}
        if hasattr(r, "error_bound"):          # the Eq. 5–9 widths too
            d["hw95"] = r.error_bound(0.95).numpy().tobytes()
        out[name] = d
    return out


def assert_emission_bitwise(a, b):
    """Everything of two emissions but the wall-clock latency."""
    for f in ("index", "interval", "watermark", "open_interval", "on_time",
              "late", "dropped", "items"):
        assert getattr(a, f) == getattr(b, f), (a.index, f)
    assert a.capacity.tobytes() == b.capacity.tobytes(), a.index
    assert results_bits(a.results) == results_bits(b.results), a.index


def state_bits(state) -> dict:
    """The state's leaf bytes by path, less the wall-clock controller
    leaves."""
    return {p: a.tobytes() for p, a in convert.named_leaves(
        convert.host_state(state))
        if p not in (".ctrl.latency_ema", ".ctrl.pressure")}


def assert_exactly_once(reference, pre, ckpt, recovered):
    combined = exactly_once_output(pre, ckpt, recovered)
    assert [em.index for em in combined] == list(range(len(reference)))
    if recovered:
        assert recovered[0].index == ckpt.emissions_done
    for a, b in zip(reference, combined):
        assert_emission_bitwise(a, b)


def surviving_payloads(victim, stream, every_chunks, key):
    """One checkpointed run of ``victim`` over ``stream``. Returns, for a
    kill after chunk ``k``, the payload that survives it (the newest one
    saved by then, ``[0]`` the save at offset 0) and the emissions made
    by then. The victim is deterministic: a run killed after chunk ``k``
    would have saved the same bytes, so one run serves every kill
    point."""
    victim.reset(key)
    ck = ckp.Checkpointer(every_chunks=every_chunks)
    victim.checkpointer = ck
    ck.save(victim)
    payloads, emitted = [ck.latest], [0]
    for c in stream:
        victim.push(c)
        payloads.append(ck.latest)
        emitted.append(len(victim.emissions))
    victim.checkpointer = None
    return payloads, [victim.emissions[:n] for n in emitted]


def sweep(mode, cfg, registry, stream, crash_points, every_chunks):
    """Kill after every chunk in ``crash_points``; recovery into a warm
    executor built with another key; emissions and final state bit for
    bit against the uninterrupted run. Returns that run's emissions."""
    victim = port_executor(mode, cfg, registry, KEY)
    recovery = port_executor(mode, cfg, registry, OTHER_KEY)
    reference = victim.run(stream)
    final = state_bits(victim.state)
    payloads, pre = surviving_payloads(victim, stream, every_chunks,
                                       prng.PRNGKey(KEY))
    for k in crash_points:
        ckpt = recovery.restore(payloads[k])
        for c in stream[ckpt.stream_offset:]:
            recovery.push(c)
        assert ckpt.stream_offset <= k
        assert_exactly_once(reference, pre[k], ckpt, recovery.finalize())
        assert state_bits(recovery.state) == final, k
    return reference


# ---------------------------------------------------------------------------
# The kill-after-every-chunk sweeps (the port against itself, bitwise).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ingest", INGESTS)
@pytest.mark.parametrize("emission", EMISSIONS)
@pytest.mark.parametrize("mode", MODES)
def test_crash_sweep_every_chunk_bitwise(mode, emission, ingest):
    """Checkpoint cadence 3 against emission cadence 2: restores land in
    the middle of emission periods and micro-batches."""
    registry = (every_kind_registry() if emission == "cadence"
                else watermark_registry())
    cfg = cfg_kw(emission=emission, ingest=ingest)
    reference = sweep(mode, cfg, registry, chunks()[1], range(1, N), 3)
    assert len(reference) >= 2
    if emission == "watermark":
        assert [em.interval for em in reference] == \
            list(range(len(reference)))
        assert reference[-1].results["key_sum"].value.shape == (3,)


@pytest.mark.parametrize("mode", MODES)
def test_crash_sweep_with_adaptive_controller(mode):
    """With an accuracy budget the capacity moves (asserted), so a wrong
    controller restore would change the adopted capacities, the
    reservoirs and the widths; recovery is still bitwise, and the
    uninterrupted run's capacities are the reference's."""
    stream = chunks(seed=8, chunk_size=256)
    cfg = cfg_kw(**budget_kw(tex))
    reference = sweep(mode, cfg, linear_registry(), stream[1],
                      (1, 3, 4, 6, 7), 3)
    caps = np.stack([em.capacity for em in reference])
    assert len(np.unique(caps)) > 1          # the feedback reallocated
    je = ref_executor(mode, cfg_kw(**budget_kw(jex)), linear_registry(jreg),
                      KEY)
    jems = je.run(stream[0])
    assert [np.asarray(em.capacity).tolist() for em in jems] == \
        caps.tolist()


@functools.lru_cache(maxsize=None)
def _warm_pair():
    """A victim and a recovery executor, warm, and the uninterrupted
    run's emissions and final state (emission period 3)."""
    cfg = cfg_kw(emit_every=3)
    victim = port_executor("pipelined", cfg, linear_registry(), KEY)
    recovery = port_executor("pipelined", cfg, linear_registry(), OTHER_KEY)
    reference = victim.run(chunks()[1])
    return victim, recovery, reference, state_bits(victim.state)


@settings(max_examples=8, deadline=None)
@given(crash_after=st.integers(1, N - 1), every=st.integers(1, 5))
def test_crash_anywhere_any_cadence(crash_after, every):
    """Any crash point under any checkpoint cadence recovers bitwise."""
    victim, recovery, reference, final = _warm_pair()
    pre, ckpt, rec = crash_and_recover(victim, recovery, chunks()[1],
                                       crash_after, every,
                                       prng.PRNGKey(KEY))
    assert_exactly_once(reference, pre, ckpt, rec)
    assert state_bits(recovery.state) == final


# ---------------------------------------------------------------------------
# Against the reference, both directions.
# ---------------------------------------------------------------------------

CROSS = [(m, e, i) for m in MODES for e in EMISSIONS for i in INGESTS]


@pytest.mark.parametrize("mode,emission,ingest", CROSS)
def test_payloads_cross_between_packages(mode, emission, ingest):
    """A reference payload taken after chunk 5 (cadence 3: in the middle
    of an emission period) restores into the port, and the port's payload
    of the same run loads through the reference's ``from_bytes``. Both
    headers agree; each continuation ends in the other package's
    uninterrupted run (state bit for bit, emissions as parity)."""
    jstream, tstream = chunks(seed=11, disorder=0.3)
    cfg = cfg_kw(emission=emission, ingest=ingest)
    je = ref_executor(mode, cfg, linear_registry(jreg), KEY)
    te = port_executor(mode, cfg, linear_registry(), KEY)
    jref, tref = je.run(jstream), te.run(tstream)
    _assert_same_run(je, te, jref, tref)
    jfinal = jax.tree.map(np.array, jax.device_get(je.state))
    tfinal = state_bits(te.state)

    payloads = {}
    for name, ex, stream, key in (
            ("ref", je, jstream, jax.random.PRNGKey(KEY)),
            ("port", te, tstream, prng.PRNGKey(KEY))):
        ex.reset(key)
        ex.checkpointer = (jckp if name == "ref" else ckp).Checkpointer(3)
        for c in stream[:5]:
            ex.push(c)
        payloads[name] = ex.checkpointer.latest
        ex.checkpointer = None
    jhead, thead = jckp.peek(payloads["ref"]), ckp.peek(payloads["port"])
    assert jhead.keys() == thead.keys()
    for f in jhead:
        if f not in ("last_latency", "manifest"):
            assert jhead[f] == thead[f], f
    for part in ("watermark", "metrics", "open_interval", "slot_interval",
                 "emitted_through"):
        assert jhead["manifest"][part] == thead["manifest"][part], part
    assert jhead["manifest"]["controller"]["capacity"] == \
        thead["manifest"]["controller"]["capacity"]
    # Batched: the cadence point 3 snaps to the flush after chunk 2.
    assert thead["stream_offset"] == (3 if mode == "pipelined" else 2)

    # Reference payload -> the port; continue against the reference.
    rec = port_executor(mode, cfg, linear_registry(), OTHER_KEY)
    ckpt = rec.restore(payloads["ref"])
    for c in tstream[ckpt.stream_offset:]:
        rec.push(c)
    tail = rec.finalize()
    assert [em.index for em in tail] == \
        list(range(ckpt.emissions_done, len(jref)))
    _assert_emissions(jref[ckpt.emissions_done:], tail)
    assert [e.interval for e in tail] == \
        [e.interval for e in jref[ckpt.emissions_done:]]
    _assert_state_leaves_equal(jfinal, rec.state)

    # Port payload -> the reference; continue against the port.
    jckpt = jckp.from_bytes(payloads["port"], je.state)
    je.restore(jckpt)
    for c in jstream[jckpt.stream_offset:]:
        je.push(c)
    jtail = je.finalize()
    _assert_emissions(jtail, tref[jckpt.emissions_done:])
    assert [e.interval for e in jtail] == \
        [e.interval for e in tref[jckpt.emissions_done:]]
    assert state_bits(convert.state_from_numpy(
        jax_state_dict(je.state), "cpu")) == tfinal


def _assert_state_leaves_equal(jstate, tstate):
    """The reference's state and the port's, leaf by leaf in the
    reference's flatten order, named by its paths."""
    paths = jax.tree_util.tree_flatten_with_path(jstate)[0]
    ours = convert.named_leaves(convert.host_state(tstate))
    assert [jax.tree_util.keystr(p) for p, _ in paths] == \
        [p for p, _ in ours]
    for (path, a), (_, b) in zip(paths, ours):
        name = jax.tree_util.keystr(path)
        if name in (".ctrl.latency_ema", ".ctrl.pressure"):
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("mode", MODES)
def test_reference_payload_with_a_budget_restores(mode):
    """The fingerprint of an accuracy budget rounds its floats through
    f32, as the reference's does: a reference payload taken with one
    restores into the port, and the recovery continues on the reference's
    capacities."""
    jstream, tstream = chunks(seed=8, chunk_size=256)
    je = ref_executor(mode, cfg_kw(**budget_kw(jex)), linear_registry(jreg),
                      KEY)
    jref = je.run(jstream)
    je.reset(jax.random.PRNGKey(KEY))
    for c in jstream[:5]:
        je.push(c)
    payload = jckp.to_bytes(je.snapshot())
    rec = port_executor(mode, cfg_kw(**budget_kw(tex)), linear_registry(),
                        OTHER_KEY)
    ckpt = rec.restore(payload)
    for c in tstream[ckpt.stream_offset:]:
        rec.push(c)
    tail = rec.finalize()
    _assert_emissions(jref[ckpt.emissions_done:], tail)


def test_budget_fingerprint_rounds_through_f32():
    jfp = jckp.config_fingerprint(
        jex.RuntimeConfig(**cfg_kw(**budget_kw(jex))), linear_registry(jreg))
    tfp = ckp.config_fingerprint(
        tex.RuntimeConfig(**cfg_kw(**budget_kw(tex))), linear_registry())
    assert tfp == json.loads(json.dumps(jfp))
    assert tfp["controller"]["budget"]["target_half_width"] == \
        float(np.float32(0.05)) != 0.05


def test_resume_mid_period_emits_on_the_reference_chunk():
    """A snapshot two chunks into a four-chunk period: the restored port
    emits after the same chunks as the reference."""
    jstream, tstream = chunks()
    cfg = cfg_kw(emit_every=4)
    je = ref_executor("pipelined", cfg, linear_registry(jreg), KEY)
    for c in jstream[:6]:
        je.push(c)
    payload = jckp.to_bytes(je.snapshot())
    assert jckp.peek(payload)["chunks_since_emit"] == 2
    te = port_executor("pipelined", cfg, linear_registry(), OTHER_KEY)
    te.restore(payload)
    at = {}
    for e in range(6, N):
        je.push(jstream[e])
        te.push(tstream[e])
        at[e] = (len(je.emissions), len(te.emissions))
    assert [j for j, _ in at.values()] == [t + 1 for _, t in at.values()]
    assert at[N - 1] == (2, 1) and at[N - 2] == (1, 0)


# ---------------------------------------------------------------------------
# Serialization, manifest, refusals, cadence.
# ---------------------------------------------------------------------------

def _pushed(mode="pipelined", n=4, **kw):
    ex = port_executor(mode, cfg_kw(**kw), every_kind_registry(), KEY)
    for c in chunks()[1][:n]:
        ex.push(c)
    return ex


def test_payload_round_trip_and_manifest(tmp_path):
    ex = _pushed(n=6)
    ckpt = ex.snapshot()
    payload = ckp.to_bytes(ckpt)
    back = ckp.from_bytes(payload, ex.state)
    assert (back.mode, back.stream_offset, back.emissions_done) == \
        ("pipelined", 6, ckpt.emissions_done)
    for (p, a), (q, b) in zip(convert.named_leaves(ckpt.state),
                              convert.named_leaves(back.state)):
        assert p == q and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert back.state.window.intervals.key.dtype == np.uint32
    head = ckp.peek(payload)
    assert head["format"] == ckp.FORMAT == 3
    assert head["leaf_paths"][0] == ".window.intervals.values"
    assert head["leaf_paths"][-1] == ".metrics.items" and \
        len(head["leaf_paths"]) == 24
    wm = twmk.from_export(head["manifest"]["watermark"], "cpu")
    assert torch.equal(wm.on_time, ex.state.wm.on_time)
    cs = tctl.from_export(head["manifest"]["controller"], "cpu")
    assert torch.equal(cs.capacity, ex.state.ctrl.capacity)
    from repro_torch.obs import metrics as obm
    m = obm.from_export(head["manifest"]["metrics"], "cpu")
    assert torch.equal(m.ingested, ex.state.metrics.ingested)
    path = str(tmp_path / "ckpt.npz")
    ckp.save(ckpt, path)
    assert ckp.load(path, ex.state).stream_offset == 6


def test_capture_copies_the_state_out():
    """The executors update the ring in place: a snapshot and its payload
    stay as they were while more chunks are pushed."""
    ex = _pushed(n=3)
    ckpt = ex.snapshot()
    before = {p: a.copy() for p, a in convert.named_leaves(ckpt.state)}
    payload = ckp.to_bytes(ckpt)
    for c in chunks()[1][3:]:
        ex.push(c)
    for p, a in convert.named_leaves(ckpt.state):
        assert a.tobytes() == before[p].tobytes(), p
    assert ckp.to_bytes(ckpt) == payload
    assert not np.array_equal(
        ckpt.state.window.intervals.counts,
        ex.state.window.intervals.counts.numpy())


def test_convert_array_is_a_copy():
    t = torch.arange(6, dtype=torch.float32)
    a = convert._array(t)
    t += 100.0
    assert a.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    state = tex.init_state(tex.RuntimeConfig(num_strata=3, capacity=8),
                           prng.PRNGKey(0), device="cpu")
    host = convert.host_state(state)
    state.window.intervals.values.fill_(7.0)
    assert not host.window.intervals.values.any()


def _restore_fails(snap, match, mode="pipelined", registry=None, **kw):
    other = port_executor(mode, cfg_kw(**kw),
                          registry or every_kind_registry(), KEY)
    with pytest.raises(ValueError, match=match):
        other.restore(snap)


@pytest.mark.parametrize("field,change", [
    ("num_strata", dict(num_strata=4)),
    ("num_intervals", dict(num_intervals=8)),
    ("interval_span", dict(interval_span=0.5)),
    ("allowed_lateness", dict(allowed_lateness=0.1)),
    ("emit_every", dict(emit_every=4)),
    ("emission", dict(emission="watermark")),
    ("accuracy_query", dict(accuracy_query="total")),
    ("controller", dict(controller=tctl.ControllerConfig(
        budget=tad.accuracy_budget(0.5, max_per_stratum=64)))),
    ("controller", dict(controller=tctl.ControllerConfig(ema=0.25))),
])
def test_restore_refuses_semantic_drift(field, change):
    _restore_fails(_pushed().snapshot(), field, **change)


def test_restore_refuses_num_shards_and_query_drift():
    snap = _pushed().snapshot()
    snap.config = dict(snap.config, num_shards=2)
    _restore_fails(snap, "num_shards")
    snap = _pushed().snapshot()
    _restore_fails(snap, "queries", registry=linear_registry())
    qs = every_kind_registry().queries
    changed = treg.QueryRegistry()
    for q in qs:
        changed.register(q.name, q.kind, **{
            f.name: getattr(q, f.name) for f in dataclasses.fields(q)
            if f.name not in ("name", "kind")} | (
                {"qs": (0.25, 0.75)} if q.kind == "quantile" else {}))
    _restore_fails(snap, "queries", registry=changed)


def test_restore_refuses_mode_shape_dtype_format_and_order():
    snap = _pushed("batched").snapshot()
    _restore_fails(snap, "batched")
    _restore_fails(snap, "shape", mode="batched", capacity=32)
    snap = _pushed().snapshot()
    wrong = dataclasses.replace(snap, state=convert.map_leaves(
        snap.state, lambda p, a: a.astype(np.int64)
        if p == ".window.intervals.counts" else a))
    _restore_fails(wrong, "dtype")
    ex = _pushed()
    payload = ckp.to_bytes(snap)
    with pytest.raises(ValueError, match="shape"):
        ckp.from_bytes(payload, port_executor(
            "pipelined", cfg_kw(capacity=32), every_kind_registry(),
            KEY).state)
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(str(arrays["__header__"][()]))
    for change, match in ((dict(format=2), "format 2"),
                          (dict(leaf_paths=[header["leaf_paths"][1],
                                            header["leaf_paths"][0]]
                                + header["leaf_paths"][2:]),
                           "leaf order mismatch")):
        buf = io.BytesIO()
        np.savez(buf, **dict(arrays, __header__=np.asarray(
            json.dumps(dict(header, **change)))))
        with pytest.raises(ValueError, match=match):
            ckp.from_bytes(buf.getvalue(), ex.state)


def test_checkpointer_cadence_retention_and_flush_snap(tmp_path):
    stream = chunks()[1]
    ck = ckp.Checkpointer(every_chunks=2, keep=None,
                          directory=str(tmp_path))
    ex = port_executor("pipelined", cfg_kw(), linear_registry(), KEY,
                       checkpointer=ck)
    for c in stream:
        ex.push(c)
    assert [off for off, _ in ck.saved] == [2, 4, 6, 8]
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [f"ckpt_{o:08d}.npz" for o in (2, 4, 6, 8)]
    assert (tmp_path / "ckpt_00000008.npz").read_bytes() == ck.latest
    # Batched with batch_chunks=4: cadence points between flushes snap
    # back to the last flush (and dedupe instead of repeating).
    ck2 = ckp.Checkpointer(every_chunks=2, keep=2)
    ex2 = port_executor("batched", cfg_kw(batch_chunks=4),
                        linear_registry(), KEY, checkpointer=ck2)
    for c in stream:
        ex2.push(c)
    assert [off for off, _ in ck2.saved] == [4, 8]
    assert ckp.peek(ck2.latest)["items_since_emit"] == 0
    with pytest.raises(ValueError, match="every_chunks"):
        ckp.Checkpointer(every_chunks=0)
    with pytest.raises(ValueError, match="keep"):
        ckp.Checkpointer(every_chunks=1, keep=0)


def test_batched_snapshot_leaves_pending_items_out():
    ex = port_executor("batched", cfg_kw(batch_chunks=4), linear_registry(),
                       KEY)
    for c in chunks()[1][:6]:
        ex.push(c)
    snap = ex.snapshot()
    assert (snap.stream_offset, snap.items_since_emit) == (4, 0)
    assert len(ex._pending) == 2 and ex._items_since_emit == 2 * 128


def test_reset_clears_checkpointer_retention():
    ck = ckp.Checkpointer(every_chunks=4)
    ex = port_executor("pipelined", cfg_kw(), linear_registry(), KEY,
                       checkpointer=ck)
    for c in chunks()[1][:4]:
        ex.push(c)
    payload_a = ck.latest
    assert ck.latest_offset == 4
    ex.reset(prng.PRNGKey(1))
    assert ck.latest is None
    for c in chunks(seed=52)[1][:4]:
        ex.push(c)
    assert ck.latest_offset == 4 and ck.latest != payload_a
    rec = port_executor("pipelined", cfg_kw(), linear_registry(), 3)
    rec.restore(ck.latest)
    assert torch.equal(rec.state.window.intervals.counts,
                       ex.state.window.intervals.counts)


def test_restore_lands_in_fresh_allocations():
    """Every restored leaf is a tensor of its own, apart from the
    checkpoint's arrays and from every other leaf."""
    ex = _pushed()
    snap = ex.snapshot()
    rec = port_executor("pipelined", cfg_kw(), every_kind_registry(), 5)
    rec.restore(snap)
    ptrs = [t.data_ptr() for _, t in convert.named_leaves(rec.state)]
    assert len(set(ptrs)) == len(ptrs)
    rec.state.window.intervals.values.fill_(1.0)
    assert not (snap.state.window.intervals.values == 1.0).all()


def test_sharded_configurations_are_still_refused():
    """A sharded reference payload names its shard count and restores
    into the port's vmap placement (the continuation is the reference's
    run); a mesh executor takes a checkpointer, and what it still refuses
    is a missing process group."""
    jstream, tstream = chunks(seed=13, disorder=0.3, num_shards=2)
    cfg = cfg_kw(num_shards=2)
    je = ref_executor("pipelined", cfg, linear_registry(jreg), KEY)
    jref = je.run(jstream)
    jfinal = jax.tree.map(np.array, jax.device_get(je.state))
    je.reset(jax.random.PRNGKey(KEY))
    for c in jstream[:5]:
        je.push(c)
    payload = jckp.to_bytes(je.snapshot())
    assert jckp.peek(payload)["config"]["num_shards"] == 2
    rec = port_executor("pipelined", cfg, linear_registry(), OTHER_KEY)
    ckpt = rec.restore(payload)
    assert rec.state.window.intervals.values.shape[0] == 2
    for c in tstream[ckpt.stream_offset:]:
        rec.push(c)
    _assert_emissions(jref[ckpt.emissions_done:], rec.finalize())
    _assert_state_leaves_equal(jfinal, rec.state)
    with pytest.raises(ValueError, match="init_process_group"):
        port_executor("pipelined", cfg_kw(num_shards=2, placement="mesh"),
                      linear_registry(), KEY,
                      checkpointer=ckp.Checkpointer(every_chunks=2))


SHARDED = [("pipelined", "cadence", "fused"),
           ("batched", "watermark", "onekernel")]


@pytest.mark.parametrize("mode,emission,ingest", SHARDED)
def test_sharded_payloads_cross_between_packages(mode, emission, ingest):
    """W = 4 on the vmap placement: a reference payload restores into the
    port and the port's loads through the reference's ``from_bytes``,
    with the same ``[W]``-leading leaves under the same names; each
    continuation ends in the other package's uninterrupted run."""
    jstream, tstream = chunks(seed=17, disorder=0.3, num_shards=4,
                              chunk_size=64)
    cfg = cfg_kw(emission=emission, ingest=ingest, num_shards=4)
    je = ref_executor(mode, cfg, linear_registry(jreg), KEY)
    te = port_executor(mode, cfg, linear_registry(), KEY)
    jref, tref = je.run(jstream), te.run(tstream)
    _assert_same_run(je, te, jref, tref)
    jfinal = jax.tree.map(np.array, jax.device_get(je.state))
    tfinal = state_bits(te.state)
    payloads = {}
    for name, ex, stream, key in (
            ("ref", je, jstream, jax.random.PRNGKey(KEY)),
            ("port", te, tstream, prng.PRNGKey(KEY))):
        ex.reset(key)
        for c in stream[:5]:
            ex.push(c)
        payloads[name] = (jckp if name == "ref" else ckp).to_bytes(
            ex.snapshot())
    jhead, thead = jckp.peek(payloads["ref"]), ckp.peek(payloads["port"])
    assert jhead["leaf_paths"] == thead["leaf_paths"]
    for f in ("stream_offset", "emissions_done", "config"):
        assert jhead[f] == thead[f], f
    for part in ("watermark", "metrics", "open_interval", "slot_interval"):
        assert jhead["manifest"][part] == thead["manifest"][part], part
    assert np.shape(thead["manifest"]["open_interval"]) == (4,)

    rec = port_executor(mode, cfg, linear_registry(), OTHER_KEY)
    ckpt = rec.restore(payloads["ref"])
    for c in tstream[ckpt.stream_offset:]:
        rec.push(c)
    _assert_emissions(jref[ckpt.emissions_done:], rec.finalize())
    _assert_state_leaves_equal(jfinal, rec.state)

    jckpt = jckp.from_bytes(payloads["port"], je.state)
    je.restore(jckpt)
    for c in jstream[jckpt.stream_offset:]:
        je.push(c)
    _assert_emissions(je.finalize(), tref[jckpt.emissions_done:])
    assert state_bits(convert.state_from_numpy(
        jax_state_dict(je.state), "cpu")) == tfinal


@pytest.mark.parametrize("mode,emission,ingest", SHARDED)
def test_sharded_crash_sweep_every_chunk_bitwise(mode, emission, ingest):
    """The kill-after-every-chunk sweep at W = 4 (checkpoint cadence 3
    against emission cadence 2)."""
    registry = (every_kind_registry() if emission == "cadence"
                else watermark_registry())
    cfg = cfg_kw(emission=emission, ingest=ingest, num_shards=4)
    stream = chunks(seed=19, disorder=0.3, num_shards=4, chunk_size=64)[1]
    reference = sweep(mode, cfg, registry, stream, range(1, N), 3)
    assert len(reference) >= 2
