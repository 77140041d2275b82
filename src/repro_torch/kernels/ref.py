"""Plain PyTorch versions of the two hand-written kernels.

These are what the wrappers in ``kernels/ops.py`` run for tensors on the
CPU, and what ``chip_smoke.py`` holds each kernel against on the card.
They compute the same functions as the kernels with PyTorch's own
operators; neither is a yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.utils import bincount, rank_within_stratum


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
