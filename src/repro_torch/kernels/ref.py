"""Plain PyTorch versions of the hand-written kernels.

These are what the wrappers in ``kernels/ops.py`` run for tensors on the
CPU, and what ``chip_smoke.py`` holds each kernel against on the card.
They compute the same functions as the kernels with PyTorch's own
operators; neither is a yardstick of speed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import (bincount, rank_within_stratum, tree_flatten,
                               tree_map)

#: f32 -inf and int32 minimum stand-ins of the reference's masked maxima.
_NEG_TIME = float(np.float32(-3.0e38))
_IMIN = -(2 ** 31) + 1


def _fold_winners(stratum_ids: torch.Tensor, u_accept: torch.Tensor,
                  u_slot: torch.Tensor, mask: torch.Tensor,
                  counts: torch.Tensor, capacity: torch.Tensor, n_max: int):
    """The fold's decisions: the ``[S·N_max]`` int64 winner of each ring
    cell (the index of the last accepted item that claims it, -1 for
    none) and the new ``[S]`` int32 counts."""
    m = stratum_ids.shape[0]
    s_cnt = counts.shape[0]
    dev = counts.device
    sid = torch.where(mask, stratum_ids.to(torch.int32), s_cnt)
    occ = rank_within_stratum(sid)
    clamped = torch.clamp(sid, max=s_cnt - 1).long()
    c = counts[clamped] + occ + 1
    cap = capacity[clamped]
    capf = cap.to(torch.float32)
    rand_slot = torch.floor(u_slot * capf).to(torch.int32)
    rand_slot = torch.minimum(torch.clamp(rand_slot, min=0),
                              torch.clamp(cap - 1, min=0))
    filling = c <= cap
    accept = mask & (filling | (u_accept * c.to(torch.float32) < capf))
    slot = torch.where(filling, c - 1, rand_slot)

    flat = sid.long() * n_max + slot.long()
    flat = torch.where(accept, flat, s_cnt * n_max)
    order = torch.arange(m, dtype=torch.int64, device=dev)
    winner = torch.full((s_cnt * n_max + 1,), -1, dtype=torch.int64,
                        device=dev)
    winner.scatter_reduce_(0, flat, order, reduce="amax")
    return (winner[: s_cnt * n_max],
            counts + bincount(sid.long(), s_cnt + 1)[:s_cnt])


def _write_winners(winner: torch.Tensor, payload: torch.Tensor,
                   values: torch.Tensor) -> None:
    """Each won cell of ``values`` (``S·N_max`` cells of any leading
    shape, then one item's shape) takes its winner's row of ``payload
    [M, *item]``, in place."""
    if payload.shape[0] == 0:
        return
    rows = values.view(winner.shape[0], -1)
    src = payload.reshape(payload.shape[0], -1)
    rows.copy_(torch.where((winner >= 0)[:, None],
                           src[torch.clamp(winner, min=0)], rows))


def fold_lead(stratum_ids, u_accept, u_slot, mask, counts,
              capacity) -> tuple:
    """The leading batch of a fold call: ``()`` for one fold (``counts
    [S]``), ``(W, K)`` for W·K folds (``counts [W, K, S]``, the
    reference's nested ``vmap`` of its kernel over shards and ring
    slots). A batched call takes ``stratum_ids``, ``u_accept`` and
    ``u_slot`` ``[W, M]``, ``mask`` ``[W, K, M]`` and ``capacity`` ``[W,
    K, S]``: the K folds of a shard read its item row. A shape that
    disagrees raises ``ValueError``."""
    if counts.ndim not in (1, 3):
        raise ValueError(f"reservoir_fold: counts has shape "
                         f"{tuple(counts.shape)}, expected [S] or "
                         "[W, K, S]")
    lead = tuple(counts.shape[:-1])
    m = stratum_ids.shape[-1] if stratum_ids.ndim else 0
    want = dict(stratum_ids=lead[:1] + (m,), u_accept=lead[:1] + (m,),
                u_slot=lead[:1] + (m,), mask=lead + (m,),
                capacity=tuple(counts.shape))
    got = dict(stratum_ids=stratum_ids, u_accept=u_accept, u_slot=u_slot,
               mask=mask, capacity=capacity)
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(
                f"reservoir_fold: {name} has shape "
                f"{tuple(got[name].shape)}, expected {shape} (the leading "
                f"fold batch {lead} of counts {tuple(counts.shape)})")
    return lead


def check_fold_payload(payload, values, m: int, lead: tuple = ()) -> list:
    """The ``(payload, values)`` leaf pairs of one fold call, as both
    versions take them: ``values`` a tensor ``[S, N_max, *item]`` or a
    tree of them (one ``S`` and ``N_max``), ``payload`` the same
    structure of ``[M, *item]`` leaves; batched (``lead = (W, K)``,
    :func:`fold_lead`), each values leaf ``[W, K, S, N_max, *item]`` and
    each payload leaf ``[W, M, *item]``. A structure mismatch raises
    ``ValueError``, as the reference's ``jax.tree.map`` does."""
    pay, pay_def = tree_flatten(payload)
    val, val_def = tree_flatten(values)
    if pay_def != val_def:
        raise ValueError(f"payload structure {pay_def} != values "
                         f"structure {val_def}")
    if not val:
        raise ValueError("reservoir_fold: the payload has no leaves")
    if not all(isinstance(t, torch.Tensor) for t in pay + val):
        raise TypeError("reservoir_fold: every payload and values leaf "
                        "must be a tensor")
    n = len(lead)
    ring = tuple(val[0].shape[:n + 2])
    for p, v in zip(pay, val):
        if (v.dim() < n + 2 or tuple(v.shape[:n + 2]) != ring
                or tuple(v.shape[:n]) != lead):
            raise ValueError(f"values leaf {tuple(v.shape)} is not "
                             f"{list(lead)} + [S, N_max, ...] with "
                             f"[S, N_max] = {ring[n:]}")
        if tuple(p.shape) != lead[:1] + (m,) + tuple(v.shape[n + 2:]):
            raise ValueError(f"payload leaf {tuple(p.shape)} does not "
                             f"match items {list(lead[:1] + (m,))} of "
                             f"values leaf {tuple(v.shape)}")
    return list(zip(pay, val))


def reservoir_fold(stratum_ids: torch.Tensor, payload,
                   u_accept: torch.Tensor, u_slot: torch.Tensor,
                   mask: torch.Tensor, counts: torch.Tensor,
                   capacity: torch.Tensor, values) -> torch.Tensor:
    """Fold an ``[M]`` chunk into ``values [S, N_max, ...]`` (or a tree of
    such leaves, ``payload`` the same tree of ``[M, ...]``) with exact
    sequential Vitter semantics, given pre-drawn uniforms.

    The rank/scatter-max form of the reference's ``apply_chunk_uniforms``:
    item ``j`` of stratum ``s`` is the ``counts[s] + rank_j + 1``-th
    arrival, accepted if it still fills the reservoir or if
    ``u·c < N_s`` (f32), and the latest accepted item wins each cell;
    the decisions are taken once and every leaf's row is written at its
    winners' cells.

    ``values`` is updated IN PLACE (the ring is owned by the caller and
    never re-materialised); returns the new ``[S]`` int32 counts.

    Batched over W·K folds (:func:`fold_lead`: ``counts [W, K, S]``,
    ``values [W, K, S, N_max, ...]``, ``mask [W, K, M]``, the items
    ``[W, M]``), fold ``(w, k)`` folds shard ``w``'s items under its own
    mask into its own ``[S, N_max]`` slice: the reference's nested
    ``vmap`` of its kernel. It is one flat fold over ``W·K·S`` cells of
    ``W·K·M`` items, fold by fold, each fold's items in order: no cell
    mixes folds and each fold's latest accepted item wins, so every fold
    is bit for bit its unbatched call. Returns ``[W, K, S]`` counts.
    """
    lead = fold_lead(stratum_ids, u_accept, u_slot, mask, counts, capacity)
    m = stratum_ids.shape[-1]
    leaves = check_fold_payload(payload, values, m, lead)
    if not lead:                                  # a batch of one fold
        return reservoir_fold(
            stratum_ids[None], tree_map(lambda t: t[None], payload),
            u_accept[None], u_slot[None], mask[None, None],
            counts[None, None], capacity[None, None],
            tree_map(lambda t: t[None, None], values))[0, 0]
    w, k = lead
    s_cnt = counts.shape[-1]
    fold = torch.arange(w * k, dtype=torch.int32,
                        device=counts.device).view(w, k, 1)
    sid = stratum_ids.to(torch.int32)[:, None, :]
    live = mask & (sid >= 0) & (sid < s_cnt)   # the kernel's "no cell"
    winner, new_counts = _fold_winners(
        (fold * s_cnt + sid).reshape(-1),
        u_accept[:, None, :].expand(w, k, m).reshape(-1),
        u_slot[:, None, :].expand(w, k, m).reshape(-1), live.reshape(-1),
        counts.reshape(-1), capacity.reshape(-1), leaves[0][1].shape[3])
    # Item b·M + j of the flat fold is item j of shard b // K.
    row = torch.where(winner >= 0, winner // max(k * m, 1) * m
                      + winner % max(m, 1), -1)
    for pay, val in leaves:
        _write_winners(row, pay.reshape((w * m,) + pay.shape[2:]), val)
    return new_counts.view(w, k, s_cnt)


def _window_level(v: torch.Tensor, sid: torch.Tensor, pos: torch.Tensor,
                  length: torch.Tensor, cap: int):
    """One level of XLA's CPU reduction of every stratum's sequence at
    once: a sequence of ``L > 32`` items is zero-padded to a multiple of
    32 (half the padding in front) and each window of 32 summed in order;
    one of ``L <= 32`` is summed in order. ``v``/``sid``/``pos``: each
    item's value, stratum (``S`` for none) and place in its sequence;
    ``length [S]``. Returns the next level's items (one per window, at
    most ``cap``) and lengths. No host read."""
    dev = v.device
    num = length.shape[0]
    big = length > 32
    padded = -(-length // 32) * 32
    low = torch.where(big, (padded - length) // 2, 0)
    nwin = torch.where(big, padded // 32, torch.clamp(length, max=1))
    ends = torch.cumsum(nwin, 0)
    base = torch.cat([ends.new_zeros(1), ends])        # [S + 1]
    live = sid < num
    s_c = torch.clamp(sid, max=num - 1)
    q = pos + low[s_c]
    win = torch.where(live, base[s_c] + q // 32, cap)
    table = torch.zeros((cap + 1, 32), dtype=v.dtype, device=dev)
    table[win, q % 32] = torch.where(live, v, 0.0)
    acc = table[:cap, 0]
    for j in range(1, 32):
        acc = acc + table[:cap, j]
    w = torch.arange(cap, dtype=ends.dtype, device=dev)
    wsid = torch.searchsorted(ends, w, right=True)
    wpos = w - base[torch.clamp(wsid, max=num - 1)]
    return acc, wsid, wpos, nwin


def stratified_stats(values: torch.Tensor, stratum_ids: torch.Tensor,
                     mask: torch.Tensor, num_strata: int):
    """Per-stratum ``(count, Σx·m, Σ(x·m)·x)`` as three ``[S]`` f32.

    The sums are f32 in the order of the reference's moments
    (``error.stratum_stats_from_sample``: ``jnp.sum`` over each row of
    ``[S, N]`` slots on XLA's CPU backend): each stratum's items in index
    order, a masked-out item as 0 in its place, reduced as
    ``prng.xla_sum`` reduces a row, every stratum at once (no host read).
    On the slot layout of an emission (row ids as strata) the sums are
    the reference's bit for bit; items with an id outside ``[0, S)`` are
    dropped. The kernel sums in another order and is held to this by
    rtol.
    """
    from repro_torch.utils import rank_within_stratum
    dev = values.device
    m = values.shape[0]
    x = torch.where(mask, values.to(torch.float32), 0.0)
    valid = (stratum_ids >= 0) & (stratum_ids < num_strata)
    sid = torch.where(valid, stratum_ids, num_strata).long()
    counts = torch.zeros(num_strata + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, sid, mask.to(torch.int64))
    length = torch.zeros(num_strata + 1, dtype=torch.int64, device=dev)
    length.index_add_(0, sid, torch.ones_like(sid))
    length = length[:num_strata]
    pos = rank_within_stratum(sid).long()
    cap = m // 32 + num_strata + 1          # windows of any level
    out = []
    for v in (x, x * x):
        v_l, s_l, p_l, n_l = v, sid, pos, length
        n = m
        while True:
            v_l, s_l, p_l, n_l = _window_level(v_l, s_l, p_l, n_l, cap)
            if n <= 32:
                break
            n = -(-n // 32)
        # One window per stratum is left: its sum.
        first = torch.cumsum(n_l, 0) - n_l
        out.append(torch.where(n_l > 0, v_l[torch.clamp(
            first, max=cap - 1)], 0.0))
    return counts[:num_strata].to(torch.float32), out[0], out[1]


def row_ids(g: int, n: int, device) -> torch.Tensor:
    """The flat ``[G·N]`` int32 stratum of each slot of a ``[G, N]`` view:
    its row (contiguous, as the kernels take it)."""
    return torch.arange(g, dtype=torch.int32,
                        device=device).repeat_interleave(n)


def stratified_stats_rows(values: torch.Tensor, mask: torch.Tensor):
    """Per-row ``(count, Σx·m, Σ(x·m)·x)`` of a ``[G, N]`` view, three f32
    ``[G]``: :func:`stratified_stats` of the flat view with row ids (the
    reference's row sums bit for bit)."""
    g, n = values.shape
    return stratified_stats(values.reshape(-1), row_ids(g, n, values.device),
                            mask.reshape(-1), g)


def weighted_hist_rows(values: torch.Tensor, row_weights: torch.Tensor,
                       mask: torch.Tensor, edges: torch.Tensor):
    """Per-(row, bin) ``(whist, counts)`` of a ``[G, N]`` view whose row
    ``g`` weighs ``row_weights[g]``: :func:`weighted_hist` of the flat
    view with row ids and each row's weight on each of its slots."""
    g, n = values.shape
    return weighted_hist(values.reshape(-1), row_ids(g, n, values.device),
                         row_weights.repeat_interleave(n), mask.reshape(-1),
                         edges, g)


def weighted_hist(values: torch.Tensor, stratum_ids: torch.Tensor,
                  weights: torch.Tensor, mask: torch.Tensor,
                  edges: torch.Tensor, num_strata: int):
    """Per-(cell, bin) HT-weighted mass and sampled-item count, both f32
    ``[G, B]`` with ``G = num_strata`` cells (the reference's
    ``weighted_hist_ref``).

    Bin ``b`` is ``[edges[b], edges[b+1])`` and the last bin is
    right-closed, as the reference's comparisons ``x >= lo``, ``x < hi``,
    ``x <= hi`` (last bin) say. For non-decreasing edges the one bin of
    ``x`` in ``[edges[0], edges[B]]`` is the largest ``b <= B - 1`` with
    ``edges[b] <= x`` (duplicate edges included), found by one
    ``searchsorted``, so the pass is ``O(M)``, not an ``[M, B]`` table.
    Masked-out items, NaN values and cell ids outside ``[0, G)`` add
    nothing. The mass is summed in f64 and rounded once and the counts in
    int64, so this is the better-rounded of the two versions and the
    kernel is held to it by rtol. No host read.
    """
    b = edges.shape[0] - 1
    x = values.to(torch.float32)
    cell = stratum_ids.long()
    inside = (mask & (x >= edges[0]) & (x <= edges[b]) & (cell >= 0)
              & (cell < num_strata))
    bin_ = torch.clamp(torch.searchsorted(edges, x, right=True) - 1, 0,
                       b - 1)
    keys = num_strata * b
    key = torch.where(inside, cell * b + bin_, keys)
    whist = torch.zeros(keys + 1, dtype=torch.float64, device=values.device)
    counts = torch.zeros(keys + 1, dtype=torch.int64, device=values.device)
    whist.index_add_(0, key, torch.where(inside, weights.double(), 0.0))
    counts.index_add_(0, key, inside.long())
    return (whist[:keys].view(num_strata, b).to(torch.float32),
            counts[:keys].view(num_strata, b).to(torch.float32))


@dataclasses.dataclass
class OneShotResult:
    """What one ingest call leaves behind (the reference's
    ``OneShotResult``); every field is the caller's tensor, updated in
    place."""
    values: object                # [K, S, N_max] ring, or a tree of them
    counts: torch.Tensor          # [K, S] i32 cell arrival counts
    capacity: torch.Tensor        # [K, S] i32 cell capacities
    slot_interval: torch.Tensor   # [K] i32 interval held per ring slot
    max_time: torch.Tensor        # () f32 event-time frontier
    open_interval: torch.Tensor   # () i32 newest interval
    on_time: torch.Tensor         # () i32 cumulative watermark accounting
    late: torch.Tensor            # () i32
    dropped: torch.Tensor         # () i32
    chunks: torch.Tensor          # () i32 chunks folded
    items: torch.Tensor           # () i32 masked items folded
    counters: torch.Tensor        # [6, S] i32 obs rows (COUNTER_FIELDS)

    @classmethod
    def of(cls, state: dict) -> "OneShotResult":
        """The result of a call on the carried tensors ``state`` (by
        keyword; its read-only ``adopt`` is left out)."""
        return cls(**{f.name: state[f.name]
                      for f in dataclasses.fields(cls)})


def one_shot_lead(times, tensors: dict) -> tuple:
    """The leading shard axis of a one-shot call: ``()`` for one chunk
    (``times [M]``), ``(W,)`` for a call batched over W shards (``times
    [W, M]``, the reference's ``vmap`` of its kernel), where every other
    tensor of ``tensors`` (name to tensor or tree) leads with the same
    ``[W]``; a leading axis that disagrees raises ``ValueError``."""
    if times.ndim not in (1, 2):
        raise ValueError(f"one_shot_ingest: times has shape "
                         f"{tuple(times.shape)}, expected [M] or [W, M]")
    if times.ndim == 1:
        return ()
    w = times.shape[0]
    for name, tree in tensors.items():
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor) and (t.ndim == 0
                                                or t.shape[0] != w):
                raise ValueError(
                    f"one_shot_ingest: {name} has shape {tuple(t.shape)}, "
                    f"expected a leading shard axis of {w} (times "
                    f"{tuple(times.shape)})")
    return (w,)


def check_one_shot_payload(payload, values, m: int, k: int, s: int,
                           lead: tuple = ()) -> list:
    """The ``(payload, values)`` leaf pairs of one call, as both versions
    take them: ``payload`` a tensor or a tree (dict, tuple, list) of
    ``[M]`` leaves with ``values``'s structure, each values leaf
    ``[K, S, N_max]`` (one ``N_max``) and each payload leaf of its
    values leaf's dtype, float32 or int32 (the two may be mixed in a
    tree), each after the call's ``lead`` (:func:`one_shot_lead`).
    Refuses what the reference refuses, for its reasons."""
    pay, pay_def = tree_flatten(payload)
    val, val_def = tree_flatten(values)
    if pay_def != val_def:
        raise ValueError(f"payload structure {pay_def} != values "
                         f"structure {val_def}")
    if not val:
        raise ValueError("one_shot_ingest: the payload has no leaves")
    if not all(isinstance(t, torch.Tensor) for t in pay + val):
        raise TypeError("one_shot_ingest: every payload and values leaf "
                        "must be a tensor")
    n_max = val[0].shape[-1] if val[0].ndim else 0
    for p, v in zip(pay, val):
        if tuple(v.shape) != lead + (k, s, n_max):
            raise ValueError(
                "one_shot_ingest handles scalar payload layouts only "
                f"([M] items into [K, S, N_max] rings); got values leaf "
                f"{tuple(v.shape)}")
        if tuple(p.shape) != lead + (m,) or p.dtype != v.dtype:
            raise ValueError(
                f"payload leaf {tuple(p.shape)}/{p.dtype} does not match "
                f"items [{m}] / values dtype {v.dtype}")
        if p.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"one_shot_ingest: payload leaf {p.dtype} must "
                            "be a 4-byte type (float32 or int32)")
    return list(zip(pay, val))


def one_shot_ingest(times, stratum_ids, payload, mask, u_accept, u_slot, *,
                    max_time, open_interval, on_time, late, dropped, chunks,
                    items, slot_interval, adopt, counts, capacity, values,
                    counters, span: float,
                    allowed_lateness: float) -> OneShotResult:
    """The whole ingest of one ``[M]`` chunk, IN PLACE on every carried
    tensor (the reference's ``one_shot_ingest``, same keywords).

    Routing is ``watermark.route_chunk``'s: the interval is
    ``floor(t * f32(1/span))`` (what the reference's compiled step
    computes), items are judged against the PRE-chunk watermark
    ``max_time - f32(lateness)`` and evicted against the POST-chunk
    newest interval; late means older than the PRE-chunk newest interval.
    Recycled slots reset their counts and adopt ``adopt`` (clamped to
    ``N_max`` by the caller). The fold is :func:`reservoir_fold`'s over
    the flattened ``[K·S, N_max]`` view, its decisions taken once and
    every payload leaf written at its winners' cells; the counter rows
    are ``obs/metrics.ingest_update``'s.

    Batched over W shards (``times [W, M]`` and every other tensor with
    the same leading ``[W]``, :func:`one_shot_lead`), it is W unbatched
    calls, shard after shard, each on its shard's views: the reference's
    ``vmap`` of its kernel.
    """
    state = dict(max_time=max_time, open_interval=open_interval,
                 on_time=on_time, late=late, dropped=dropped, chunks=chunks,
                 items=items, slot_interval=slot_interval, adopt=adopt,
                 counts=counts, capacity=capacity, values=values,
                 counters=counters)
    lead = one_shot_lead(times, dict(
        stratum_ids=stratum_ids, payload=payload, mask=mask,
        u_accept=u_accept, u_slot=u_slot, **state))
    if lead:
        for w in range(lead[0]):
            one_shot_ingest(
                times[w], stratum_ids[w], tree_map(lambda t: t[w], payload),
                mask[w], u_accept[w], u_slot[w], span=span,
                allowed_lateness=allowed_lateness,
                **{n: tree_map(lambda t: t[w], v) for n, v in state.items()})
        return OneShotResult.of(state)
    k, s_cnt = counts.shape
    m = times.shape[0]
    leaves = check_one_shot_payload(payload, values, m, k, s_cnt)
    n_max = leaves[0][1].shape[-1]
    dev = counts.device
    i32 = torch.int32
    recip = float(np.float32(1.0) / np.float32(span))
    wmark = max_time - float(np.float32(allowed_lateness))   # pre-chunk
    tgt = torch.floor(times * recip).to(i32)
    if m:
        new_max = torch.maximum(
            max_time, torch.max(torch.where(mask, times, _NEG_TIME)))
        new_open = torch.maximum(
            open_interval, torch.max(torch.where(mask, tgt, _IMIN)))
    else:
        new_max, new_open = max_time.clone(), open_interval.clone()
    slots = torch.arange(k, dtype=i32, device=dev)
    desired = new_open - torch.remainder(new_open - slots, k)
    reset = (desired != slot_interval)[:, None]
    counts.copy_(torch.where(reset, 0, counts))
    capacity.copy_(torch.where(reset, adopt[None, :], capacity))
    c0 = counts.clone()

    live = mask & ~(times < wmark) & ~(tgt < new_open - k + 1)
    cell = torch.remainder(tgt, k) * s_cnt + stratum_ids.to(i32)
    winner, new_counts = _fold_winners(cell, u_accept, u_slot, live,
                                       counts.view(-1), capacity.view(-1),
                                       n_max)
    for pay, val in leaves:
        _write_winners(winner, pay, val)
    counts.copy_(new_counts.view(k, s_cnt))

    def per_stratum(pred):
        sid = torch.where(pred, stratum_ids.to(i32), s_cnt)
        return bincount(sid, s_cnt + 1)[:s_cnt]

    def total(pred):
        return torch.sum(pred, dtype=i32)

    late_v = live & (tgt < open_interval)
    counters[0] += per_stratum(mask)                  # ingested
    counters[1] += per_stratum(live)                  # accepted
    counters[2] += per_stratum(late_v)                # late
    counters[3] += per_stratum(mask & ~live)          # dropped
    f0 = torch.minimum(c0, capacity)
    f1 = torch.minimum(counts, capacity)
    counters[4] += torch.sum((counts - c0) - (f1 - f0), dim=0, dtype=i32)
    counters[5] = torch.sum(f1, dim=0, dtype=i32)     # occupancy gauge
    on_time += total(live & ~late_v)
    late += total(late_v)
    dropped += total(mask & ~live)
    items += total(mask)
    chunks += 1
    max_time.copy_(new_max)
    open_interval.copy_(new_open)
    slot_interval.copy_(desired)
    return OneShotResult.of(state)
