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

from repro_torch.utils import bincount, rank_within_stratum

#: f32 -inf and int32 minimum stand-ins of the reference's masked maxima.
_NEG_TIME = float(np.float32(-3.0e38))
_IMIN = -(2 ** 31) + 1


def reservoir_fold(stratum_ids: torch.Tensor, payload: torch.Tensor,
                   u_accept: torch.Tensor, u_slot: torch.Tensor,
                   mask: torch.Tensor, counts: torch.Tensor,
                   capacity: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """Fold an ``[M]`` chunk into ``values [S, N_max]`` with exact
    sequential Vitter semantics, given pre-drawn uniforms.

    The rank/scatter-max form of the reference's ``apply_chunk_uniforms``:
    item ``j`` of stratum ``s`` is the ``counts[s] + rank_j + 1``-th
    arrival, accepted if it still fills the reservoir or if
    ``u·c < N_s`` (f32), and the latest accepted item wins each cell.

    ``values`` is updated IN PLACE (the ring is owned by the caller and
    never re-materialised); returns the new ``[S]`` int32 counts.
    """
    m = stratum_ids.shape[0]
    s_cnt, n_max = values.shape
    dev = values.device
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
    winner = winner[: s_cnt * n_max]
    src = torch.clamp(winner, min=0)
    flat_values = values.view(-1)
    flat_values.copy_(torch.where(winner >= 0, payload[src], flat_values))
    return counts + bincount(sid.long(), s_cnt + 1)[:s_cnt]


def stratified_stats(values: torch.Tensor, stratum_ids: torch.Tensor,
                     mask: torch.Tensor, num_strata: int):
    """Per-stratum ``(count, Σx·m, Σ(x·m)·x)`` as three ``[S]`` f32.

    A masked ``index_add_``. The products are taken in f32 as the kernel
    takes them; the sums run in f64 and are rounded once, so this is the
    better-rounded of the two and the kernel is held to it by rtol.
    """
    m = mask.to(torch.float32)
    x = torch.where(mask, values.to(torch.float32), 0.0)
    sid = torch.where(mask, stratum_ids, 0).long()
    out = torch.zeros((3, num_strata), dtype=torch.float64,
                      device=values.device)
    out[0].index_add_(0, sid, m.double())
    out[1].index_add_(0, sid, x.double())
    out[2].index_add_(0, sid, (x * x).double())
    out = out.to(torch.float32)
    return out[0], out[1], out[2]


def weighted_hist(values: torch.Tensor, stratum_ids: torch.Tensor,
                  weights: torch.Tensor, mask: torch.Tensor,
                  edges: torch.Tensor, num_strata: int):
    """Per-(cell, bin) HT-weighted mass and sampled-item count, both f32
    ``[G, B]`` with ``G = num_strata`` cells (the reference's
    ``weighted_hist_ref``).

    Bin ``b`` is ``[edges[b], edges[b+1])`` and the last bin is
    right-closed: the comparisons ``x >= lo``, then ``x < hi``, then
    ``x <= hi`` on the last bin, literally, over an ``[M, B]`` membership
    table. Masked-out items add nothing. The mass is summed in f64 and
    rounded once and the counts in int64, so this is the better-rounded
    of the two versions and the kernel is held to it by rtol.
    """
    b = edges.shape[0] - 1
    x = values.to(torch.float32)[:, None]
    lo, hi = edges[:b][None, :], edges[1:][None, :]
    closed = (torch.arange(b, device=values.device) == b - 1)[None, :]
    in_bin = (x >= lo) & torch.where(closed, x <= hi, x < hi)
    in_bin &= mask[:, None]
    cell = torch.where(mask, stratum_ids, 0).long()
    whist = torch.zeros((num_strata, b), dtype=torch.float64,
                        device=values.device)
    counts = torch.zeros((num_strata, b), dtype=torch.int64,
                         device=values.device)
    whist.index_add_(0, cell, in_bin * weights.double()[:, None])
    counts.index_add_(0, cell, in_bin.long())
    return whist.to(torch.float32), counts.to(torch.float32)


@dataclasses.dataclass
class OneShotResult:
    """What one ingest call leaves behind (the reference's
    ``OneShotResult``); every field is the caller's tensor, updated in
    place."""
    values: torch.Tensor          # [K, S, N_max] ring
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


def check_one_shot_payload(payload, values) -> None:
    """One payload leaf of a 4-byte type, as both versions take."""
    if not isinstance(payload, torch.Tensor) or \
            not isinstance(values, torch.Tensor):
        raise NotImplementedError(
            "one_shot_ingest takes one payload tensor; values plus "
            "heavy-hitter keys come with ROADMAP Queue 1 item 8")
    if payload.dtype not in (torch.float32, torch.int32) or \
            values.dtype != payload.dtype:
        raise TypeError(f"one_shot_ingest: payload {payload.dtype} and "
                        f"values {values.dtype} must be one 4-byte type "
                        "(float32 or int32)")
    if values.ndim != 3:
        raise ValueError(f"values must be [K, S, N_max], got "
                         f"{tuple(values.shape)}")


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
    ``N_max`` by the caller). The fold is :func:`reservoir_fold` over the
    flattened ``[K·S, N_max]`` view, and the counter rows are
    ``obs/metrics.ingest_update``'s.
    """
    check_one_shot_payload(payload, values)
    k, s_cnt, n_max = values.shape
    m = times.shape[0]
    dev = values.device
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
    new_counts = reservoir_fold(cell, payload, u_accept, u_slot, live,
                                counts.view(-1), capacity.view(-1),
                                values.view(k * s_cnt, n_max))
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
    return OneShotResult(
        values=values, counts=counts, capacity=capacity,
        slot_interval=slot_interval, max_time=max_time,
        open_interval=open_interval, on_time=on_time, late=late,
        dropped=dropped, chunks=chunks, items=items, counters=counters)
