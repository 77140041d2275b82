"""Checkpoints on ``placement="mesh"`` and the 4→8→4 rescale across
process groups, on the CPU (gloo ranks).

Three sequential spawns (``test_torch_distributed.spawn_ranks``), the way
a real rescale restarts a job at a new width: 4 ranks run the first
segment, 8 ranks the second, 4 ranks the third; the payload migrated at
each boundary passes to the next spawn through a file. The parent runs
the same schedule on the vmap placement (``test_torch_rescale``'s
harness, numpy ramp chunks) and holds the mesh to it:

* every per-chunk payload of the mesh (the cadence checkpointer's newest,
  every 2 chunks) is the vmap schedule's (every leaf but the wall-clock
  controller EMA and pressure, every header field but the latency), and
  every rank holds the same bytes;
* the migrated payloads at both boundaries, and the emissions of the
  three segments, are the vmap schedule's;
* two recoveries on the mesh: killed at the 4→8 boundary (restored at
  W = 4 in a fresh executor, the rescale re-done) and after chunk 7
  (restored at W = 8 from offset 6, replayed), each giving the
  uninterrupted payloads and emissions.

The first spawn also holds a mesh capture to the vmap capture after the
same chunks (one all_gather, nothing else), and restores a vmap payload
and a reference payload into the mesh: both continue as the vmap run.
"""
import functools
import pickle

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import distributed as dist
from repro_torch.runtime import checkpoint as ckp
from test_torch_distributed import init_group, spawn_ranks
from test_torch_mesh import emission_bits
from test_torch_rescale import (KEY, boundary_sync, cfg_kw,
                                header_fields, port_executor, ramp_chunk,
                                rescale, start_segment, state_bits)

NAME = "pipelined-cadence"
DISORDER = 0.3
EVERY = 2
OTHER = 999
SEGMENTS = [(4, 0, 4), (8, 4, 8), (4, 8, 12)]   # (W, start, end)
RESTORE_AT, RESTORE_END = 3, 6                   # cross-placement restores


def slot_widths():
    """The per-shard slot width at each width (``ceil(capacity / W)``)."""
    cap = cfg_kw(NAME, 1)["capacity"]
    return {w: -(-cap // w) for w in (4, 8)}


def chunk(offset, w):
    return ramp_chunk(offset, w, disorder=DISORDER)


def run_segment(ex, seg, payload, key=None):
    """Segment ``seg`` on ``ex`` (reset with ``key`` or restored from
    ``payload``, from its offset), a checkpoint every EVERY chunks and one
    at its start. Returns the payload newest after each push (the one a
    kill after that chunk leaves), the segment's emissions and the
    payload migrated for the next width (``None`` after the last)."""
    w, start, end = SEGMENTS[seg]
    off = ckp.peek(payload)["stream_offset"] if payload else start
    start_segment(ex, payload, key, EVERY)
    per_chunk = []
    for o in range(off, end):
        ex.push(chunk(o, w))
        per_chunk.append(ex.checkpointer.latest)
    ex.checkpointer = None
    if seg == len(SEGMENTS) - 1:
        return per_chunk, ex.finalize(), None
    boundary_sync(ex)
    ems = list(ex.emissions)
    w_next = SEGMENTS[seg + 1][0]
    return per_chunk, ems, rescale(ex, w_next, slot_widths()[w_next])


def payload_bits(payload):
    """A payload's header and leaves but the wall-clock parts."""
    w = int(ckp.peek(payload)["config"]["num_shards"])
    return header_fields(payload), state_bits(
        ckp.from_bytes(payload, _template(w)).state)


@functools.lru_cache(maxsize=None)
def _template(w):
    """A state of width ``w`` (the leaves' shapes and dtypes)."""
    return port_executor(NAME, w, KEY).state


def _rank_segment(rank, world, init, seg, payload_in, extra, out_dir):
    """One rank of segment ``seg``: the uninterrupted segment, a recovery
    (segment 0: at the boundary; segment 1: killed after chunk 7), and in
    segment 0 the capture and cross-placement restores."""
    torch.set_num_threads(1)
    init_group(rank, world, init)
    w = SEGMENTS[seg][0]
    out = {}
    if seg == 0:
        ex = port_executor(NAME, w, KEY, placement="mesh")
        for o in range(RESTORE_AT + 1):
            ex.push(chunk(o, w))
        dist.reset_collective_counts()
        out["capture"] = ckp.to_bytes(ex.snapshot())
        out["capture_counts"] = dist.collective_counts()
        for name, payload in extra.items():
            rec = port_executor(NAME, w, OTHER, placement="mesh")
            snap = rec.restore(payload)
            for o in range(snap.stream_offset, RESTORE_END):
                rec.push(chunk(o, w))
            out[f"restored_{name}"] = [emission_bits(e)
                                       for e in rec.finalize()]
    ex = port_executor(NAME, w, KEY, placement="mesh")
    per_chunk, ems, migrated = run_segment(ex, seg, payload_in,
                                           key=prng.PRNGKey(KEY))
    out.update(per_chunk=per_chunk, emissions=[emission_bits(e)
                                               for e in ems],
               migrated=migrated, final=state_bits(ex.state))
    if seg < 2:
        # Killed at the 4→8 boundary (after chunk 4), or after chunk 7.
        survivor = per_chunk[-1] if seg == 0 else per_chunk[7 - 1 - 4]
        rec = port_executor(NAME, w, OTHER, placement="mesh")
        _, rems, rmig = run_segment(rec, seg, survivor)
        out["recovery"] = dict(
            offset=ckp.peek(survivor)["stream_offset"],
            emissions_done=ckp.peek(survivor)["emissions_done"],
            emissions=[emission_bits(e) for e in rems], migrated=rmig)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _spawn(seg, payload_in, extra, tmp):
    d = tmp / f"seg{seg}"
    d.mkdir()
    w = SEGMENTS[seg][0]
    spawn_ranks(_rank_segment, (seg, payload_in, extra, str(d)), d, w)
    out = []
    for r in range(w):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _vmap_schedule():
    """The schedule on the vmap placement: per segment, the payload newest
    after each push, the emissions and the migrated payload."""
    executors = {w: port_executor(NAME, w, KEY) for w in (4, 8)}
    out, payload = [], None
    for seg, (w, _, _) in enumerate(SEGMENTS):
        per_chunk, ems, migrated = run_segment(
            executors[w], seg, payload, key=prng.PRNGKey(KEY))
        out.append(dict(per_chunk=per_chunk, emissions=[
            emission_bits(e) for e in ems], migrated=migrated,
            final=state_bits(executors[w].state)))
        payload = migrated
    return out


def _restore_inputs():
    """A vmap payload and a reference payload after RESTORE_AT chunks, and
    the vmap run's emissions over RESTORE_END chunks."""
    import jax
    from repro.runtime import checkpoint as jckp
    from repro.runtime import executor as jex
    from repro.runtime import registry as jreg
    from repro.runtime.records import TimestampedChunk as JChunk
    from test_torch_rescale import registry
    ex = port_executor(NAME, 4, KEY)
    je = jex.PipelinedExecutor(jex.RuntimeConfig(**cfg_kw(NAME, 4)),
                               registry(jreg), jax.random.PRNGKey(KEY))
    payloads = {}
    for o in range(RESTORE_END):
        c = chunk(o, 4)
        ex.push(c)
        je.push(JChunk(*(jax.numpy.asarray(getattr(c, f).numpy()) for f in
                         ("values", "stratum_ids", "times", "mask"))))
        if o + 1 == RESTORE_AT:
            payloads = {"vmap": ckp.to_bytes(ex.snapshot()),
                        "reference": jckp.to_bytes(je.snapshot())}
        if o == RESTORE_AT:
            capture = ckp.to_bytes(ex.snapshot())
    ems = [emission_bits(e) for e in ex.finalize()]
    return payloads, capture, ems


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three spawns, the vmap schedule and the restore inputs."""
    tmp = tmp_path_factory.mktemp("mesh_rescale")
    payloads, capture, restore_ems = _restore_inputs()
    mesh, payload = [], None
    for seg in range(len(SEGMENTS)):
        ranks = _spawn(seg, payload, payloads if seg == 0 else {}, tmp)
        mesh.append(ranks)
        payload = ranks[0]["migrated"]
    return dict(mesh=mesh, vmap=_vmap_schedule(), capture=capture,
                restore_ems=restore_ems)


def test_mesh_capture_is_the_vmap_capture(runs):
    """After the same chunks, every rank's capture is the vmap placement's
    (leaves, cursors, fingerprint), with one all_gather."""
    want = payload_bits(runs["capture"])
    for rank in runs["mesh"][0]:
        assert rank["capture_counts"] == {"all_reduce": 0, "all_gather": 1}
        assert payload_bits(rank["capture"]) == want
    assert len({r["capture"] for r in runs["mesh"][0]}) == 1


@pytest.mark.parametrize("source", ["vmap", "reference"])
def test_payloads_restore_into_the_mesh(source, runs):
    """A vmap payload and a reference payload, restored into the mesh in
    an executor with another key, continue as the vmap run."""
    done = len(runs["restore_ems"]) - len(
        runs["mesh"][0][0][f"restored_{source}"])
    assert done > 0
    for rank in runs["mesh"][0]:
        assert rank[f"restored_{source}"] == runs["restore_ems"][done:]


@pytest.mark.parametrize("seg", range(len(SEGMENTS)))
def test_mesh_schedule_is_the_vmap_schedules(seg, runs):
    """Each segment on the mesh: its per-chunk payloads (every rank the
    same bytes), emissions, migrated payload and final shard rows are the
    vmap schedule's."""
    want = runs["vmap"][seg]
    ranks = runs["mesh"][seg]
    assert len(ranks) == SEGMENTS[seg][0]
    for i, payload in enumerate(want["per_chunk"]):
        assert len({r["per_chunk"][i] for r in ranks}) == 1, i
        assert payload_bits(ranks[0]["per_chunk"][i]) == \
            payload_bits(payload), i
    for r in ranks:
        assert r["emissions"] == want["emissions"]
    if want["migrated"] is not None:
        assert len({r["migrated"] for r in ranks}) == 1
        assert payload_bits(ranks[0]["migrated"]) == \
            payload_bits(want["migrated"])
    final = {p: np.frombuffer(b, np.uint8) for p, b in want["final"].items()}
    for rank, r in enumerate(ranks):
        for p, b in r["final"].items():
            row = final[p].reshape(len(ranks), -1)[rank]
            assert row.tobytes() == b, (rank, p)
    assert sum(len(v["emissions"]) for v in runs["vmap"]) >= 5


@pytest.mark.parametrize("seg", [0, 1])
def test_mesh_recovery_around_the_rescale(seg, runs):
    """Killed at the 4→8 boundary (restored at W = 4, the rescale re-done)
    and after chunk 7 (restored at W = 8, chunks 6 and 7 replayed): the
    re-emitted answers and the migrated payload are the uninterrupted
    run's."""
    want = runs["vmap"][seg]
    for r in runs["mesh"][seg]:
        rec = r["recovery"]
        assert rec["offset"] == (4 if seg == 0 else 6)
        done = rec["emissions_done"] - (0 if seg == 0 else len(
            [e for v in runs["vmap"][:seg] for e in v["emissions"]]))
        assert rec["emissions"] == want["emissions"][done:]
        assert payload_bits(rec["migrated"]) == payload_bits(
            want["migrated"])
