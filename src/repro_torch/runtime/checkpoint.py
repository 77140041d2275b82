"""Checkpoint and restore for exactly-once execution.

Counterpart of the reference's ``runtime/checkpoint.py``, with its
payload format: a payload either package writes loads in the other.
StreamApprox's error bounds (Eqs. 5–9) hold only if every stream
interval is counted exactly once; a worker crash that drops or
double-counts intervals voids them. Exactly-once is a state snapshot, a
deterministic source rewind and emission-cursor dedupe:

* :class:`RuntimeCheckpoint` — one executor's snapshot: the state
  (reservoirs with their PRNG keys, the ring's slot table, the watermark
  frontier and counters, the controller, the device counters) copied to
  the host, and the host cursors (stream offset, emission cursor,
  emission-period position, micro-batch size, watermark emission's
  emitted-through cursor and base key).
* :class:`Checkpointer` — the cadence sink: every ``every_chunks``
  pushes it captures and serializes the executor; the payload bytes are
  all that is assumed to survive a crash.
* :func:`capture` / :func:`restore_into` — the executor hooks. Restoring
  into a fresh executor (any key) and replaying the chunks from
  ``stream_offset`` gives the uninterrupted run's emissions and state
  bit for bit; emissions re-made after the snapshot carry the same
  ``Emission.index``, so a consumer keeping the first copy per index
  sees the uninterrupted output.

The payload is ``numpy.savez`` of the state's leaves (``leaf_0`` ...,
named in the header by the reference's pytree paths, key words as u32)
and a JSON header with the host cursors, the semantic fingerprint of the
configuration and a manifest; no pickle. The capture copies the state
out: the executors update the ring in place, so a live reference would
change under the next push. On the card that copy is the host's wait
for the queued work, at a chunk boundary.

A sharded executor checkpoints like one shard: its leaves carry the
leading ``[W]`` axis under the reference's names, so a W-shard payload
crosses between the packages both ways. On ``placement="mesh"`` the
capture gathers every rank's ``[1]``-leading shard into the same
``[W]``-leading state with one all_gather, every rank holds the same
checkpoint, and a restore keeps the rank's own row: the fingerprint
names no placement, so a payload moves between the placements too.

:func:`migrate` is the restore-time rescale: it re-packs a payload's
reservoirs for another shard count (and slot width), on the host, with
one gather per cell and no loop over samples.
"""
from __future__ import annotations

import dataclasses
import io
import json
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import distributed as dist
from repro_torch.obs import metrics as obm
from repro_torch.runtime import controller as ctl
from repro_torch.runtime import convert
from repro_torch.runtime import watermark as wmk

# Format 3: the reference's, whose state carries the device counters.
FORMAT = 3
_HEADER = "__header__"

#: RuntimeConfig fields that change event-time or emission semantics
#: without changing any array shape: a restore across differing values
#: would mis-route replayed items or re-emit answers over other windows
#: under the same indices, so they are fingerprinted and checked.
_SEMANTIC_FIELDS = ("num_strata", "num_intervals", "interval_span",
                    "allowed_lateness", "num_shards", "emit_every",
                    "emission", "accuracy_query", "controller", "queries")

def config_fingerprint(cfg, registry) -> dict:
    """The reference's fingerprint of the same configuration, equal
    under JSON: tuples as lists, the budget's floats rounded through f32
    (the reference holds them as f32 scalars), a ``count`` predicate
    recorded by its presence only."""
    fp = {f: getattr(cfg, f) for f in
          ("num_strata", "num_intervals", "interval_span",
           "allowed_lateness", "num_shards", "emit_every", "emission",
           "accuracy_query")}
    b = cfg.controller.budget
    fp["controller"] = {
        "budget": None if b is None else {
            "target_half_width": float(np.float32(b.target_half_width)),
            "z": float(np.float32(b.z)),
            "min_per_stratum": int(b.min_per_stratum),
            "max_per_stratum": int(b.max_per_stratum)},
        "latency_budget_s": cfg.controller.latency_budget_s,
        "ema": cfg.controller.ema,
        "min_per_stratum": cfg.controller.min_per_stratum,
    }
    fp["queries"] = [
        [q.name, q.kind,
         None if q.qs is None else list(q.qs),
         None if q.edges is None else list(q.edges),
         q.k, q.num_replicates, q.method, q.predicate is not None,
         q.window, q.session_gap]
        for q in registry.queries]
    return fp


def incorporated_offset(ex) -> int:
    """Chunks whose effect is in the executor's state: pushes less the
    batched executor's pending chunks (a checkpoint's ``stream_offset``)."""
    return ex.chunks_pushed - len(getattr(ex, "_pending", ()))


@dataclasses.dataclass
class RuntimeCheckpoint:
    """One executor snapshot: host state and host cursors.

    ``stream_offset`` counts the chunks whose effect is in ``state`` (the
    batched executor's snaps to its last flush: pending chunks are
    recovered by replay). ``emissions_done`` is the index the next
    emission carries.
    """
    mode: str                 # "batched" | "pipelined"
    stream_offset: int        # chunks fully incorporated into `state`
    emissions_done: int       # emission cursor at the snapshot
    items_since_emit: int     # items incorporated since the last emission
    chunks_since_emit: int    # pipelined emission-period position
    batch_chunks: int         # batched micro-batch size
    last_latency: float       # controller feedback carried into next step
    state: Any                # RuntimeState of numpy arrays (host_state)
    config: dict              # semantic RuntimeConfig fingerprint
    emitted_through: int = -1  # watermark emission: newest emitted interval
    emit_key: Any = None      # watermark emission base key (two u32 ints)


def capture(ex) -> RuntimeCheckpoint:
    """Snapshot an executor at a chunk boundary (waits for the card).

    The batched executor's pending chunks are not captured: the offset
    points before them and replay re-pushes them, which re-forms the
    same micro-batches.
    """
    pending_items = sum(c.values.numel() for c in getattr(ex, "_pending", ()))
    state, last_latency = _every_shard(ex)
    return RuntimeCheckpoint(
        mode=ex.mode,
        stream_offset=incorporated_offset(ex),
        emissions_done=ex._emission_cursor,
        items_since_emit=ex._items_since_emit - pending_items,
        chunks_since_emit=getattr(ex, "_chunks_since_emit", 0),
        batch_chunks=getattr(ex, "batch_chunks", 0),
        last_latency=last_latency,
        state=convert.host_state(state),
        config=config_fingerprint(ex.cfg, ex.registry),
        emitted_through=ex._emitted_through,
        emit_key=ex._emit_base_key.tolist(),
    )


def _every_shard(ex) -> Tuple[Any, float]:
    """The executor's state with every shard and its last latency. On the
    mesh every rank calls it at the same offset: ONE all_gather of every
    rank's ``[1]``-leading leaves stacks them ``[W]``-leading, bitwise the
    vmap placement's state, and every rank takes rank 0's latency (the
    one its controllers were fed), as the f64 bits of a Python float."""
    if ex.mesh is None:
        return ex.state, float(ex._last_latency)
    leaves = [t for _, t in convert.named_leaves(ex.state)]
    lat = torch.tensor([ex._last_latency], dtype=torch.float64,
                       device=ex.device).view(torch.int32)[None]
    *rows, lat_all = dist.gather_shards(leaves + [lat])
    it = iter(rows)
    state = convert.map_leaves(ex.state, lambda _p, _t: next(it))
    return state, float(lat_all[0].clone().view(torch.float64)[0])


def restore_into(ex, ckpt: RuntimeCheckpoint) -> None:
    """Load a checkpoint into an executor (fresh, with any key, or used).

    Every leaf lands on the executor's device in a fresh allocation, so
    the views the emission hands the stats and histogram kernels keep
    the address phase of a fresh run; a mesh rank checks the whole
    ``[W]``-leading state and keeps its own row. Replay the chunks from
    ``ckpt.stream_offset`` afterwards.
    """
    if ckpt.mode != ex.mode:
        raise ValueError(
            f"checkpoint was taken from a {ckpt.mode!r} executor; "
            f"cannot restore into {ex.mode!r} (the modes' host cursors "
            "are not interchangeable)")
    here = config_fingerprint(ex.cfg, ex.registry)
    for f in _SEMANTIC_FIELDS:
        if ckpt.config.get(f) != here[f]:
            raise ValueError(
                f"checkpoint was taken under {f}={ckpt.config.get(f)!r}, "
                f"executor has {f}={here[f]!r}; restoring across "
                "event-time/emission semantics would corrupt the "
                "replayed answer stream")
    _validate_state(ex.payload_template(), ckpt.state)
    cursors = dict(emitted_through=ckpt.emitted_through,
                   emit_base_key=ckpt.emit_key,
                   items_since_emit=ckpt.items_since_emit,
                   last_latency=ckpt.last_latency)
    if ex.mode == "batched":
        cursors["batch_chunks"] = ckpt.batch_chunks
    else:
        cursors["chunks_since_emit"] = ckpt.chunks_since_emit
    ex.emissions = []
    # A mesh rank's resume keeps its row of the whole state.
    ex.resume(convert.device_state(
        ckpt.state, ex.device if ex.mesh is None else "cpu"),
              ckpt.stream_offset, ckpt.emissions_done, **cursors)


def _validate_state(template, state) -> None:
    """Refuse a mismatched state with the leaf's name, before any of it
    reaches the executor."""
    t_leaves, s_leaves = (convert.named_leaves(template),
                          convert.named_leaves(state))
    t_paths, s_paths = [p for p, _ in t_leaves], [p for p, _ in s_leaves]
    if t_paths != s_paths:
        raise ValueError(
            f"checkpoint state structure {s_paths} does not match this "
            f"executor's {t_paths} (different RuntimeConfig?)")
    for (name, t_leaf), (_, s_leaf) in zip(t_leaves, s_leaves):
        if tuple(t_leaf.shape) != tuple(np.shape(s_leaf)):
            raise ValueError(
                f"checkpoint leaf {name} has shape {np.shape(s_leaf)}, "
                f"executor expects {tuple(t_leaf.shape)} (num_strata / "
                "num_intervals / num_shards / N_max mismatch)")
        want = convert.payload_dtype(name, t_leaf)
        if np.dtype(s_leaf.dtype) != want:
            raise ValueError(
                f"checkpoint leaf {name} has dtype {s_leaf.dtype}, "
                f"executor expects {want}")


# ---------------------------------------------------------------------------
# Restore-time elastic rescale.
# ---------------------------------------------------------------------------

def _lr_split(total: int, parts: int) -> np.ndarray:
    """Largest-remainder split of ``total`` over ``parts`` (the first
    ``total mod parts`` shards take the +1)."""
    base, rem = divmod(int(total), parts)
    out = np.full((parts,), base, np.int64)
    out[:rem] += 1
    return out


def _bounded_fill(total: int, bounds: np.ndarray) -> np.ndarray:
    """``total`` units over shards, at most ``bounds[j]`` each, as the
    reference's round robin deals them one unit per shard per round, in
    closed form: every shard gets ``min(b_j, L)`` for the largest level
    ``L`` with ``Σ min(b_j, L) <= total``, and the ``r`` units left go to
    the first ``r`` shards (in index order) with ``b_j > L``."""
    b = np.asarray(bounds, np.int64)
    total = int(total)
    if total <= 0:
        return np.zeros(len(b), np.int64)
    if total >= int(b.sum()):
        return b.copy()
    lo, hi = 0, int(b.max())             # Σ min(b, hi) = Σ b > total
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if int(np.minimum(b, mid).sum()) <= total:
            lo = mid
        else:
            hi = mid - 1
    out = np.minimum(b, lo)
    out[np.flatnonzero(b > lo)[:total - int(out.sum())]] += 1
    return out


def _cell_seed(lead_key: np.ndarray, cell: int) -> int:
    """The permutation seed of one (slot, stratum) cell, from the old
    ring's lead key (two u32 words, taken as Python ints)."""
    return int((int(lead_key[0]) * 1000003 + int(lead_key[1])
                + 7919 * cell) % (2 ** 32))


def migrate(ckpt: RuntimeCheckpoint, new_num_shards: int,
            new_max_capacity: Optional[int] = None) -> RuntimeCheckpoint:
    """Restore-time elastic rescale: the checkpoint re-keyed and
    re-packed for ``new_num_shards`` shards (and a slot width
    ``new_max_capacity``, by default the old one), the reference's
    ``migrate`` bit for bit on every leaf, header field and config entry.

    Per (slot, stratum) cell, over the shards whose slot holds the
    canonical interval (the newest interval any shard saw decides which
    interval each slot holds):

    * the arrival counts ``C = Σ c_w`` re-split by largest remainder (the
      Eq. 5 totals are unchanged);
    * the pooled live samples (shard-major, each shard's ``0 … taken - 1``)
      permuted by numpy's legacy generator seeded from the old lead key
      and the cell, and dealt to the new shards in contiguous slices of
      the permutation: one gather per cell, no loop over samples;
    * adopted capacity ``min(ceil(Σ cap_w / W'), N_max)``; a shard the
      pool cannot fill adopts ``capacity = taken``, so that
      ``taken = min(counts, capacity)`` and the HT weight stay exact.

    New shard ``j``'s slot ``kk`` key is
    ``fold_in(fold_in(lead, j + 1), kk)``; the controller's global
    capacities re-split like the reservoirs, its EMA and pressure take
    the largest shard's; the watermark frontier pools to its minimum
    (no shard may drop what the old run kept); the counters and totals
    re-pool into shard 0 and the occupancy gauge is recomputed. Host
    cursors pass through: the rescaled run continues the same output.

    Runs on the host state a capture holds (the 25 MB of a full-width
    ring stay on the host); a one-shard state is lifted to
    ``[1]``-leading first, and ``W' = 1`` squeezes the shard axis.
    """
    w_new = int(new_num_shards)
    if w_new < 1:
        raise ValueError(f"new_num_shards must be >= 1, got {w_new}")
    w_old = int(ckpt.config["num_shards"])
    state = convert.map_leaves(
        ckpt.state, lambda _p, a: np.asarray(a)[None] if w_old == 1
        else np.asarray(a))

    iv = state.window.intervals
    k, s = iv.counts.shape[1], iv.counts.shape[2]
    n_new = (iv.values.shape[3] if new_max_capacity is None
             else int(new_max_capacity))
    if n_new < 1:
        raise ValueError(f"new_max_capacity must be >= 1, got {n_new}")

    # The canonical ring: slot j holds the newest live interval = j mod K.
    open_new = int(np.max(state.open_interval))
    desired = (open_new - np.mod(open_new - np.arange(k), k)).astype(
        np.int32)
    lead = iv.key.reshape(-1, iv.key.shape[-1])[0]
    old_taken = np.minimum(iv.counts, iv.capacity)             # [W, K, S]

    new_counts = np.zeros((w_new, k, s), np.int32)
    new_cap = np.zeros((w_new, k, s), np.int32)
    new_values = np.zeros((w_new, k, s, n_new), iv.values.dtype)
    for kk in range(k):
        part = state.slot_interval[:, kk] == desired[kk]        # [W_old]
        for ss in range(s):
            tw = np.where(part, old_taken[:, kk, ss], 0)
            c_total = int(np.where(part, iv.counts[:, kk, ss], 0).sum())
            cap_total = int(np.where(part, iv.capacity[:, kk, ss], 0).sum())
            y_total = int(tw.sum())
            adopt = min(max(-(-cap_total // w_new), 1), n_new)
            cj = _lr_split(c_total, w_new)
            want = np.minimum(cj, adopt)
            tj = want if int(want.sum()) <= y_total \
                else _bounded_fill(y_total, want)
            if y_total:
                # The pool shard-major (shard w's samples 0 … taken_w - 1),
                # one gather by the permutation's prefix, then a
                # contiguous slice of it per new shard.
                pool = np.concatenate([iv.values[w, kk, ss, :tw[w]]
                                       for w in range(w_old)])
                perm = np.random.RandomState(
                    _cell_seed(lead, kk * s + ss)).permutation(y_total)
                dealt = pool[perm[:int(tj.sum())]]
                ends = np.cumsum(tj)
                for j in range(w_new):
                    new_values[j, kk, ss, :tj[j]] = dealt[ends[j] - tj[j]:
                                                          ends[j]]
            new_counts[:, kk, ss] = cj
            new_cap[:, kk, ss] = np.where(tj == want, adopt, tj)

    # Re-key: a fold chain from the old ring's lead key.
    base = torch.as_tensor(lead.astype(np.int64))
    shard_keys = torch.stack([prng.fold_in(base, j + 1)
                              for j in range(w_new)])           # [W', 2]
    new_keys = torch.stack([prng.fold_in(shard_keys, kk)
                            for kk in range(k)], dim=1).numpy().astype(
        np.uint32)                                              # [W', K, 2]

    def resplit(g):
        per = np.minimum(np.maximum(-(-g // w_new), 1), n_new)
        return np.broadcast_to(per.astype(np.int32), (w_new, s)).copy()

    ctrl = state.ctrl
    new_ctrl = ctl.ControllerState(
        capacity=resplit(ctrl.capacity.astype(np.int64).sum(axis=0)),
        base_capacity=resplit(ctrl.base_capacity.astype(np.int64).sum(
            axis=0)),
        latency_ema=np.full((w_new,), np.max(ctrl.latency_ema), np.float32),
        pressure=np.full((w_new,), np.max(ctrl.pressure), np.float32))

    def pool_row0(x):
        out = np.zeros((w_new,) + x.shape[1:], np.int32)
        out[0] = x.astype(np.int64).sum(axis=0)
        return out

    wm = state.wm
    new_wm = wmk.WatermarkState(
        max_time=np.full((w_new,), np.min(wm.max_time), np.float32),
        on_time=pool_row0(wm.on_time), late=pool_row0(wm.late),
        dropped=pool_row0(wm.dropped))
    mt = state.metrics
    new_metrics = obm.MetricsState(
        ingested=pool_row0(mt.ingested), accepted=pool_row0(mt.accepted),
        late=pool_row0(mt.late), dropped=pool_row0(mt.dropped),
        replaced=pool_row0(mt.replaced),
        occupancy=np.minimum(new_counts, new_cap).sum(axis=1).astype(
            np.int32),
        chunks=pool_row0(mt.chunks), items=pool_row0(mt.items))

    new_state = type(state)(
        window=type(state.window)(
            intervals=type(iv)(values=new_values, counts=new_counts,
                               capacity=new_cap, key=new_keys),
            cursor=np.full((w_new,), (open_new + 1) % k, np.int32),
            filled=np.full((w_new,), min(open_new + 1, k), np.int32)),
        slot_interval=np.broadcast_to(desired, (w_new, k)).copy(),
        open_interval=np.full((w_new,), open_new, np.int32),
        wm=new_wm, ctrl=new_ctrl, metrics=new_metrics)
    if w_new == 1:
        new_state = convert.map_leaves(new_state,
                                       lambda _p, a: np.array(a[0]))
    config = dict(ckpt.config, num_shards=w_new)
    return dataclasses.replace(ckpt, state=new_state, config=config)


# ---------------------------------------------------------------------------
# Serialization (savez payload + JSON header; no pickle).
# ---------------------------------------------------------------------------

def to_bytes(ckpt: RuntimeCheckpoint) -> bytes:
    """Serialize a checkpoint to a self-describing byte payload."""
    leaves = convert.named_leaves(ckpt.state)
    header = {
        "format": FORMAT,
        "mode": ckpt.mode,
        "stream_offset": ckpt.stream_offset,
        "emissions_done": ckpt.emissions_done,
        "items_since_emit": ckpt.items_since_emit,
        "chunks_since_emit": ckpt.chunks_since_emit,
        "batch_chunks": ckpt.batch_chunks,
        "last_latency": ckpt.last_latency,
        "emitted_through": ckpt.emitted_through,
        "emit_key": ckpt.emit_key,
        "config": ckpt.config,
        "leaf_paths": [path for path, _ in leaves],
        "manifest": manifest(ckpt),
    }
    buf = io.BytesIO()
    arrays = {f"leaf_{i}": np.asarray(leaf)
              for i, (_, leaf) in enumerate(leaves)}
    np.savez(buf, **{_HEADER: np.asarray(json.dumps(header))}, **arrays)
    return buf.getvalue()


def from_bytes(data: bytes, template_state) -> RuntimeCheckpoint:
    """Deserialize against an executor's state (the template gives the
    structure; leaves are checked by name, shape and dtype)."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        header = json.loads(str(z[_HEADER][()]))
        if header.get("format") != FORMAT:
            raise ValueError(
                f"unsupported checkpoint format {header.get('format')!r}")
        leaves = [z[f"leaf_{i}"] for i in range(len(header["leaf_paths"]))]
    t_paths = [p for p, _ in convert.named_leaves(template_state)]
    if len(t_paths) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, executor state has "
            f"{len(t_paths)}")
    for path, name in zip(t_paths, header["leaf_paths"]):
        if path != name:
            raise ValueError(
                f"checkpoint leaf order mismatch: payload has {name}, "
                f"executor expects {path}")
    it = iter(leaves)
    state = convert.map_leaves(template_state, lambda _p, _l: next(it))
    ckpt = RuntimeCheckpoint(
        mode=header["mode"],
        stream_offset=header["stream_offset"],
        emissions_done=header["emissions_done"],
        items_since_emit=header["items_since_emit"],
        chunks_since_emit=header["chunks_since_emit"],
        batch_chunks=header["batch_chunks"],
        last_latency=header["last_latency"],
        state=state,
        config=header["config"],
        emitted_through=header["emitted_through"],
        emit_key=header["emit_key"],
    )
    _validate_state(template_state, state)
    return ckpt


def peek(data: bytes) -> dict:
    """A payload's JSON header, without an executor."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return json.loads(str(z[_HEADER][()]))


def manifest(ckpt: RuntimeCheckpoint) -> dict:
    """Human-readable summary of the snapshot's adaptive state."""
    st = ckpt.state
    return {
        "watermark": wmk.export(st.wm),
        "controller": ctl.export(st.ctrl),
        "metrics": obm.export(st.metrics),
        "open_interval": np.asarray(st.open_interval).tolist(),
        "slot_interval": np.asarray(st.slot_interval).tolist(),
        "emitted_through": ckpt.emitted_through,
    }


def save(ckpt: RuntimeCheckpoint, path: str) -> None:
    with open(path, "wb") as f:
        f.write(to_bytes(ckpt))


def load(path: str, template_state) -> RuntimeCheckpoint:
    with open(path, "rb") as f:
        return from_bytes(f.read(), template_state)


# ---------------------------------------------------------------------------
# Cadence-driven checkpointing.
# ---------------------------------------------------------------------------

class Checkpointer:
    """Checkpoint sink an executor calls after every push.

    Every ``every_chunks`` pushes the executor is captured and serialized
    at once: ``saved`` holds ``(stream_offset, payload)`` pairs, the only
    artifact recovery may rely on. ``keep`` bounds retention (newest
    last; ``None`` keeps all). ``directory`` also writes each payload to
    ``ckpt_<offset>.npz`` (on the mesh, rank 0 alone: every rank captures
    at the same offsets, a collective, and holds the same payload).

    Cadence trades overhead for recovery: a checkpoint costs one copy of
    the state to the host and its serialization, and a crash replays on
    average ``every_chunks / 2`` chunks.
    """

    def __init__(self, every_chunks: int, keep: Optional[int] = 1,
                 directory: Optional[str] = None):
        if every_chunks < 1:
            raise ValueError(f"every_chunks must be >= 1, got {every_chunks}")
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be >= 1 or None, got {keep}")
        self.every_chunks = every_chunks
        self.keep = keep
        self.directory = directory
        self.saved: List[Tuple[int, bytes]] = []

    @property
    def latest(self) -> Optional[bytes]:
        return self.saved[-1][1] if self.saved else None

    @property
    def latest_offset(self) -> Optional[int]:
        return self.saved[-1][0] if self.saved else None

    def clear(self) -> None:
        """Drop retained payloads (``executor.reset()`` calls this: a new
        stream must not recover the old one's snapshots). Files in
        ``directory`` are left alone."""
        self.saved = []

    def maybe(self, ex) -> bool:
        """Cadence hook (the executors call it after each push)."""
        if ex.chunks_pushed % self.every_chunks != 0:
            return False
        return self.save(ex)

    def save(self, ex) -> bool:
        """Capture and serialize now. Skips (returns False) when the
        incorporated offset has not moved since the last save: batched
        pushes between flushes change no state."""
        offset = incorporated_offset(ex)
        if self.saved and self.saved[-1][0] == offset:
            return False
        prev_offset = self.saved[-1][0] if self.saved else 0
        t0 = time.perf_counter()
        payload = to_bytes(capture(ex))
        self.saved.append((offset, payload))
        if self.keep is not None:
            del self.saved[:-self.keep]
        mesh = getattr(ex, "mesh", None)
        if self.directory is not None and (mesh is None or mesh.rank == 0):
            # Every mesh rank holds the same payload; one writes it.
            with open(f"{self.directory}/ckpt_{offset:08d}.npz", "wb") as f:
                f.write(payload)
        dt = time.perf_counter() - t0
        telemetry = getattr(ex, "telemetry", None)
        if telemetry is not None:
            # Cadence drift: chunks covered since the previous save less
            # the cadence (nonzero when batched snapshots snap to flushes).
            drift = (offset - prev_offset) - self.every_chunks
            telemetry.on_checkpoint_save(offset, len(payload), dt, drift)
        return True
