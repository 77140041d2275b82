"""Restore-time elastic rescale of the port (``checkpoint.migrate``), on
the CPU.

``migrate`` against the reference's, bit for bit on every leaf, header
field and config entry: the same reference capture, its payload loaded by
both packages, rescaled by both (4 shards to 2, 3, 8 and 1; 2 to 3 with
the N_max = 7 clamp; 1 to 4; a shard whose slot lags; a cell dealt by
``_bounded_fill``). ``_bounded_fill``'s closed form against a literal copy
of the reference's round robin.

The port's rescale harness (the behaviour of ``tests/harness_rescale.py``):
the stream runs in segments of shard counts; at each boundary the batched
executor flushes its partial micro-batch, the executor is captured, the
checkpoint migrated to the next executor's shard count and slot width,
serialized, and restored into a warm executor of the next width. A crash
after global chunk ``k`` leaves only the latest payload's bytes; recovery
replays at the payload's own width and re-performs every remaining
rescale, and the deduped output and final state must be the
uninterrupted schedule's bit for bit. The 4→8→4 schedule is killed after
every chunk on the vmap placement, pipelined fused on cadence and batched
onekernel on the watermark over a disordered stream, and its
uninterrupted run is the reference's ``run_schedule`` on the same chunks.

This module imports JAX only inside functions: the mesh ranks
(``test_torch_mesh_rescale.py``) and the CUDA test import its harness.
"""
import io
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import prng
from repro_torch.runtime import checkpoint as ckp
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from repro_torch.runtime.records import TimestampedChunk
from test_torch_mesh import emission_bits

SEGMENTS = [(4, 4), (8, 4), (4, 4)]
KEY = 0
#: name -> (executor, ingest, emission, disorder)
SCHEDULES = {
    "pipelined-cadence": ("pipelined", "fused", "cadence", 0.0),
    "batched-watermark": ("batched", "onekernel", "watermark", 0.3),
}


def _big(x):
    return x > 500.0


def registry(module=treg, windows=True):
    """Linear kinds, and with ``windows`` the per-key and session
    windows."""
    reg = (module.QueryRegistry().register("total", "sum")
           .register("avg", "mean")
           .register("big", "count", predicate=_big))
    if windows:
        reg = (reg.register("bykey", "sum", window="per_key")
               .register("sess", "sum", window="session", session_gap=0.75))
    return reg


def cfg_kw(name, w, placement="vmap", **kw):
    _, ingest, emission, _ = SCHEDULES[name]
    base = dict(num_strata=3, capacity=16, num_intervals=4,
                interval_span=1.0, allowed_lateness=0.5, batch_chunks=2,
                emit_every=2, num_shards=w, placement=placement,
                ingest=ingest, emission=emission)
    base.update(kw)
    return base


def port_executor(name, w, seed, placement="vmap", device="cpu",
                  windows=True, **kw):
    cls = tex.PipelinedExecutor if SCHEDULES[name][0] == "pipelined" else \
        tex.BatchedExecutor
    return cls(tex.RuntimeConfig(**cfg_kw(name, w, placement, **kw)),
               registry(windows=windows), prng.PRNGKey(seed), device=device)


def ramp_chunk(offset, w, m=32, seed=5, disorder=0.0, num_strata=3,
               device="cpu"):
    """numpy-made ``[W, M]`` chunk at global offset ``offset``: every row
    on the same event-time ramp, a quarter interval per chunk whatever
    ``W`` (a rescale moves no watermark), a ``disorder`` share of the items
    shifted back by up to 1.5 intervals, ~5% masked out."""
    rng = np.random.default_rng([seed, offset, w])
    mus = np.resize(np.array([10.0, 100.0, 1000.0]), num_strata)
    sid = rng.integers(0, num_strata, (w, m)).astype(np.int32)
    vals = (mus[sid] * (1.0 + 0.2 * rng.standard_normal((w, m)))
            ).astype(np.float32)
    t = np.broadcast_to((offset * m + np.arange(m)) / (4.0 * m), (w, m))
    shift = (rng.random((w, m)) < disorder) * rng.random((w, m)) * 1.5
    t = np.maximum(t - shift, 0.0).astype(np.float32)
    return TimestampedChunk(*(torch.from_numpy(np.ascontiguousarray(a)).to(
        device) for a in (vals, sid, t, rng.random((w, m)) > 0.05)))


def state_bits(state) -> dict:
    """A state's leaf bytes by path, less the wall-clock controller
    leaves (host or device state)."""
    if not isinstance(state.open_interval, np.ndarray):
        state = convert.host_state(state)
    return {p: np.asarray(a).tobytes() for p, a in convert.named_leaves(
        state) if p not in (".ctrl.latency_ema", ".ctrl.pressure")}


def header_fields(payload) -> dict:
    """A payload's header but the wall-clock parts (the latency and the
    controller's manifest, which carries the latency EMA)."""
    head = ckp.peek(payload)
    head.pop("last_latency")
    head["manifest"].pop("controller")
    return head


# ---------------------------------------------------------------------------
# The port's rescale harness.
# ---------------------------------------------------------------------------

def segment_bounds(segments):
    """``[(num_shards, start, end)]`` with global chunk offsets."""
    out, start = [], 0
    for w, n in segments:
        out.append((w, start, start + n))
        start += n
    return out


def slot_width(ex) -> int:
    """The executor's per-shard slot width ``N_max``: the width a
    migrated payload must be re-packed into."""
    return ex.state.window.intervals.values.shape[-1]


def boundary_sync(ex) -> None:
    """A rescale boundary is a barrier: the batched executor flushes its
    partial micro-batch, so the capture holds every pushed chunk."""
    if ex.mode == "batched" and ex._pending:
        ex._flush()


def rescale(ex, w_next, n_next) -> bytes:
    """Capture ``ex`` at a boundary and migrate it to ``w_next`` shards of
    slot width ``n_next``: the payload the next width restores."""
    boundary_sync(ex)
    return ckp.to_bytes(ckp.migrate(ex.snapshot(), w_next,
                                    new_max_capacity=n_next))


def start_segment(ex, payload, key, every_chunks):
    """Reset (first segment) or restore from bytes, then attach a fresh
    cadence checkpointer with a save at the segment's start."""
    ex.checkpointer = None
    if payload is None:
        ex.reset(key)
    else:
        ex.restore(payload)
    if every_chunks is not None:
        ex.checkpointer = ckp.Checkpointer(every_chunks=every_chunks)
        ex.checkpointer.save(ex)
    return ex


def drive(executors, streams, bounds, seg, ex, offset, every_chunks=None,
          watch=None):
    """Push from global ``offset`` (inside segment ``seg``) to the end of
    the schedule, rescaling at every boundary. ``watch(offset, ems, ex)``
    hears every push. Returns the emissions and the last executor."""
    ems = []
    for i in range(seg, len(bounds)):
        w, _, end = bounds[i]
        while offset < end:
            ex.push(streams[w](offset))
            offset += 1
            if watch is not None:
                watch(offset, ems + list(ex.emissions), ex)
        if i == len(bounds) - 1:
            return ems + ex.finalize(), ex
        ems += list(ex.emissions)
        nxt = executors[bounds[i + 1][0]]
        payload = rescale(ex, nxt.cfg.num_shards, slot_width(nxt))
        assert ckp.peek(payload)["stream_offset"] == end
        ex.checkpointer = None
        ex = start_segment(nxt, payload, None, every_chunks)
    raise AssertionError("empty schedule")


def run_schedule(executors, streams, segments, key, every_chunks=None,
                 watch=None):
    """The schedule from a cold start: its emissions and last executor."""
    bounds = segment_bounds(segments)
    ex = start_segment(executors[bounds[0][0]], None, key, every_chunks)
    if watch is not None:
        watch(0, [], ex)
    return drive(executors, streams, bounds, 0, ex, 0, every_chunks, watch)


def surviving_payloads(executors, streams, segments, key, every_chunks):
    """One checkpointed run of the schedule. For a kill after global chunk
    ``k``: the payload that survives it (the newest saved by then) and the
    emissions made by then. The run is deterministic, so a run killed
    after ``k`` would have saved the same bytes."""
    out = {}

    def watch(offset, ems, ex):
        out[offset] = (ex.checkpointer.latest, list(ems))
    run_schedule(executors, streams, segments, key, every_chunks, watch)
    return out


def resume_schedule(executors, streams, segments, payload):
    """Recover from ``payload`` and finish the schedule: replay at the
    payload's own width, then re-perform every remaining rescale. A
    payload at a boundary with the earlier width resumes before the
    migrate, with the later width after it."""
    bounds = segment_bounds(segments)
    head = ckp.peek(payload)
    w_ck, off = int(head["config"]["num_shards"]), int(head["stream_offset"])
    cands = [i for i, (w, s, e) in enumerate(bounds)
             if w == w_ck and s <= off <= e]
    assert cands, (w_ck, off, bounds)
    live = [i for i in cands if off < bounds[i][2]]
    seg = live[0] if live else cands[0]
    ex = start_segment(executors[w_ck], payload, None, None)
    return drive(executors, streams, bounds, seg, ex, off)


def assert_rescale_exactly_once(reference, pre_crash, payload, recovered):
    """The deduped output is the uninterrupted schedule's, bit for bit,
    with contiguous indices."""
    done = int(ckp.peek(payload)["emissions_done"])
    combined = pre_crash[:done] + recovered
    assert [em.index for em in combined] == list(range(len(reference)))
    if recovered:
        assert recovered[0].index == done
    for a, b in zip(reference, combined):
        assert emission_bits(a) == emission_bits(b), a.index


def sweep_rescale(executors, streams, segments, key, every_chunks,
                  crash_points):
    """Kill after every chunk in ``crash_points``: emissions and final
    state bit for bit the uninterrupted schedule's. Returns its
    emissions."""
    reference, last = run_schedule(executors, streams, segments, key)
    final = state_bits(last.state)
    survivors = surviving_payloads(executors, streams, segments, key,
                                   every_chunks)
    for k in crash_points:
        payload, pre = survivors[k]
        recovered, last = resume_schedule(executors, streams, segments,
                                          payload)
        assert_rescale_exactly_once(reference, pre, payload, recovered)
        assert state_bits(last.state) == final, k
    return reference


# ---------------------------------------------------------------------------
# migrate against the reference's, bitwise.
# ---------------------------------------------------------------------------

def _reference_capture(w, chunks, capacity, seed=0, disorder=0.0):
    """A reference pipelined run of ``chunks`` chunks at ``w`` shards, its
    payload, and a port executor of the same configuration."""
    import jax
    from repro.runtime import executor as jex
    from repro.runtime import registry as jreg
    from repro.stream import GaussianSource, StreamAggregator
    from repro.stream.replay import ReplayableStream
    from repro.runtime import checkpoint as jckp
    kw = dict(num_strata=3, capacity=capacity, num_intervals=4,
              interval_span=1.0, allowed_lateness=0.5, num_shards=w,
              batch_chunks=2, emit_every=2)
    je = jex.PipelinedExecutor(jex.RuntimeConfig(**kw), registry(jreg),
                               jax.random.PRNGKey(seed))
    stream = ReplayableStream(StreamAggregator(GaussianSource(), seed=7),
                              chunk_size=32, rate=64.0, num_shards=w,
                              disorder=disorder, disorder_seed=3)
    for c in stream.prefix(chunks):
        je.push(c)
    te = tex.PipelinedExecutor(tex.RuntimeConfig(**kw), registry(),
                               prng.PRNGKey(seed), device="cpu")
    return je, te, jckp.to_bytes(je.snapshot())


def _migrate_both(je, te, payload, w_new, n_new):
    """The payload loaded and migrated by both packages."""
    from repro.runtime import checkpoint as jckp
    jm = jckp.migrate(jckp.from_bytes(payload, je.state), w_new,
                      new_max_capacity=n_new)
    tm = ckp.migrate(ckp.from_bytes(payload, te.state), w_new,
                     new_max_capacity=n_new)
    return jm, tm


def assert_migrate_bitwise(jm, tm):
    """Every leaf (path, shape, dtype, bytes), header field and config
    entry."""
    import jax
    from repro.runtime import checkpoint as jckp
    jl = [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in
          jax.tree_util.tree_flatten_with_path(jax.device_get(jm.state))[0]]
    tl = [(p, np.asarray(a)) for p, a in convert.named_leaves(tm.state)]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), p
        assert a.tobytes() == b.tobytes(), p
    assert tm.config == jm.config
    assert ckp.peek(ckp.to_bytes(tm)) == jckp.peek(jckp.to_bytes(jm))


@pytest.fixture(scope="module")
def four_shards():
    return _reference_capture(4, 6, 32)


@pytest.mark.parametrize("w_new,n_new", [(2, 16), (3, 11), (8, 4), (1, 48)])
def test_migrate_is_the_references(w_new, n_new, four_shards,
                                   monkeypatch):
    """4 shards to 2, 3, 8 and 1 (the squeeze to unsharded leaves):
    bitwise, with the invariants of ``test_scaleout.py``; at 4→3 the full
    cells' pools cannot fill ``W'·ceil(Σcap/W')`` slots, so
    ``_bounded_fill`` deals them and those shards adopt ``capacity =
    taken``."""
    fills = []
    real = ckp._bounded_fill

    def counted(total, bounds):
        fills.append((total, int(np.sum(bounds))))
        return real(total, bounds)
    monkeypatch.setattr(ckp, "_bounded_fill", counted)
    je, te, payload = four_shards
    jm, tm = _migrate_both(je, te, payload, w_new, n_new)
    assert_migrate_bitwise(jm, tm)
    if w_new == 3:
        assert fills and all(t < b for t, b in fills)
    old = ckp.from_bytes(payload, te.state).state
    new, iv = tm.state, tm.state.window.intervals
    counts, cap = iv.counts.reshape(-1, 4, 3), iv.capacity.reshape(-1, 4, 3)
    assert counts.shape[0] == w_new and iv.values.shape[-1] == n_new
    np.testing.assert_array_equal(old.window.intervals.counts.sum(axis=0),
                                  counts.sum(axis=0))
    taken = np.minimum(counts, cap)
    assert (taken <= cap).all() and (cap <= n_new).all()
    assert int(np.sum(new.wm.on_time)) == int(np.sum(old.wm.on_time))
    for f in ("ingested", "accepted", "chunks", "items"):
        assert np.sum(getattr(new.metrics, f)) == \
            np.sum(getattr(old.metrics, f))
    np.testing.assert_array_equal(
        new.metrics.occupancy.reshape(-1, 3), taken.sum(axis=1))
    if w_new == 1:
        assert new.open_interval.shape == () and iv.counts.shape == (4, 3)


def test_migrate_one_shard_to_four():
    """The ``[None]`` lift of a one-shard payload, dealt to four."""
    je, te, payload = _reference_capture(1, 6, 32)
    jm, tm = _migrate_both(je, te, payload, 4, 8)
    assert_migrate_bitwise(jm, tm)
    assert tm.state.window.intervals.values.shape == (4, 4, 3, 8)


def test_migrate_clamps_at_nmax_seven():
    """Capacity 7 over 2 shards allocates 4 per shard; at 3 shards the
    ceil re-split ``ceil(8/3) = 3`` is clamped to the new slot width."""
    je, te, payload = _reference_capture(2, 4, 7, seed=1)
    assert te.state.window.intervals.values.shape[-1] == 4
    jm, tm = _migrate_both(je, te, payload, 3, 3)
    assert_migrate_bitwise(jm, tm)
    iv = tm.state.window.intervals
    assert int(iv.capacity.max()) <= 3


def test_migrate_skips_a_lagging_shard(four_shards):
    """A shard whose slot holds another interval than the canonical one
    gives that slot's pool nothing: its counts and samples drop out of
    the re-split, in both packages."""
    je, te, payload = four_shards
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(str(arrays["__header__"][()]))
    i = header["leaf_paths"].index(".slot_interval")
    slots = arrays[f"leaf_{i}"].copy()
    lagging = slots[1, 0] - 4
    slots[1, 0] = lagging
    arrays[f"leaf_{i}"] = slots
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    edited = buf.getvalue()
    jm, tm = _migrate_both(je, te, edited, 2, 16)
    assert_migrate_bitwise(jm, tm)
    old = ckp.from_bytes(edited, te.state).state.window.intervals.counts
    want = old[[0, 2, 3], 0].sum(axis=0)
    assert old[1, 0].sum() > 0
    np.testing.assert_array_equal(
        tm.state.window.intervals.counts[:, 0].sum(axis=0), want)


def test_migrate_validates_args(four_shards):
    _, te, payload = four_shards
    snap = ckp.from_bytes(payload, te.state)
    with pytest.raises(ValueError, match="new_num_shards"):
        ckp.migrate(snap, 0)
    with pytest.raises(ValueError, match="new_max_capacity"):
        ckp.migrate(snap, 2, new_max_capacity=0)


def _bounded_fill_loop(total, bounds):
    """The reference's round robin, literally."""
    out = np.zeros(len(bounds), np.int64)
    remaining = int(total)
    while remaining > 0:
        progressed = False
        for j in range(len(bounds)):
            if remaining > 0 and out[j] < bounds[j]:
                out[j] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            break
    return out


@settings(max_examples=300, deadline=None)
@given(total=st.integers(-3, 200),
       bounds=st.lists(st.integers(0, 40), min_size=1, max_size=9))
def test_bounded_fill_closed_form_is_the_round_robin(total, bounds):
    b = np.asarray(bounds, np.int64)
    got = ckp._bounded_fill(total, b)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, _bounded_fill_loop(total, b))


# ---------------------------------------------------------------------------
# The 4→8→4 schedule, killed after every chunk (vmap placement).
# ---------------------------------------------------------------------------

def _reference_streams(disorder):
    from repro.stream import GaussianSource, StreamAggregator
    from repro.stream.replay import ReplayableStream
    return {w: ReplayableStream(
        aggregator=StreamAggregator(GaussianSource(), seed=7),
        chunk_size=32, rate=64.0, num_shards=w, disorder=disorder,
        disorder_seed=3) for w in (4, 8)}


def _torch_chunk(c):
    return TimestampedChunk(*(torch.from_numpy(np.array(getattr(c, f)))
                              for f in ("values", "stratum_ids", "times",
                                        "mask")))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_rescale_4_8_4_kill_after_every_chunk(name):
    """Every kill point 0 … 12, boundaries included: bitwise exactly-once;
    the uninterrupted schedule is the reference's (integer fields,
    watermark, Σ capacity and intervals bitwise, the linear answers within
    ``test_torch_runtime``'s rtol, the final state bit for bit)."""
    import jax
    from harness_rescale import run_schedule as ref_run_schedule
    from repro.runtime import executor as jex
    from repro.runtime import registry as jreg
    from test_torch_registry import assert_results_close
    from test_torch_runtime import _assert_state_bitwise
    disorder = SCHEDULES[name][3]
    jstreams = _reference_streams(disorder)
    cache = {}

    def chunk_fn(w):
        def at(offset):
            if (w, offset) not in cache:
                cache[w, offset] = _torch_chunk(jstreams[w].chunk_at(offset))
            return cache[w, offset]
        return at
    streams = {w: chunk_fn(w) for w in (4, 8)}
    executors = {w: port_executor(name, w, KEY + w)
                 for w in (4, 8)}
    total = segment_bounds(SEGMENTS)[-1][2]
    reference = sweep_rescale(executors, streams, SEGMENTS,
                              prng.PRNGKey(KEY), every_chunks=2,
                              crash_points=range(total + 1))
    assert len(reference) >= 4

    jcls = jex.PipelinedExecutor if SCHEDULES[name][0] == "pipelined" else \
        jex.BatchedExecutor
    jexecutors = {w: jcls(jex.RuntimeConfig(**cfg_kw(name, w)),
                          registry(jreg),
                          jax.random.PRNGKey(KEY + w)) for w in (4, 8)}
    jems = ref_run_schedule(jexecutors, jstreams, SEGMENTS,
                            jax.random.PRNGKey(KEY))
    assert len(jems) == len(reference)
    for a, b in zip(jems, reference):
        for f in ("index", "interval", "watermark", "open_interval",
                  "on_time", "late", "dropped", "items"):
            assert getattr(a, f) == getattr(b, f), (a.index, f)
        np.testing.assert_array_equal(a.capacity, b.capacity)
        assert_results_close(a.results, b.results)
    _assert_state_bitwise(jexecutors[4].state, executors[4].state)
    if SCHEDULES[name][2] == "watermark":
        assert [em.interval for em in reference] == \
            list(range(len(reference)))


def test_rescale_schedule_on_ramp_chunks():
    """The harness on the numpy ramp (the stream the mesh and CUDA tests
    use), with the per-key and session windows: 4→8→4 with kills before,
    at and after both boundaries."""
    name = "batched-watermark"
    streams = {w: (lambda o, w=w: ramp_chunk(o, w, disorder=0.3))
               for w in (4, 8)}
    executors = {w: port_executor(name, w, KEY + w) for w in (4, 8)}
    reference = sweep_rescale(executors, streams, SEGMENTS,
                              prng.PRNGKey(KEY), every_chunks=3,
                              crash_points=(3, 4, 5, 8, 9, 11))
    assert len(reference) >= 2
