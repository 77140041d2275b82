"""Distributed OASRS execution, paper §3.2 "Distributed execution".

Counterpart of the reference's ``core/distributed.py``, over a
``torch.distributed`` process group where the reference takes mesh axis
names:

* Each of ``w`` workers holds a *local* OASRS state with reservoirs of
  ``N_i / w`` (:func:`split_capacity`). The ingest (:func:`local_update`)
  performs no collective: the workers never synchronize while sampling.
* A query merges the workers' partial estimates with ONE all_reduce of
  one packed f32 buffer (each worker × stratum cell is an independently
  sampled stratum, so partial estimates and partial variances both sum,
  Eq. 5). The reference's tuple ``psum`` is several collectives on its
  jax; the port packs the tuple first.
* Straggler mitigation: a worker that missed the window deadline passes
  ``alive = 0``; the surviving partials are inflated by
  ``w_total / w_alive`` (only the variance grows).
* The mesh emission (:func:`gather_cells`) is ONE all_gather of every
  worker's sample cells with a payload of integer words riding in the
  same buffer, bit-reinterpreted so that words above ``2**24`` stay
  exact.
* A mesh checkpoint (:func:`gather_shards`) is ONE all_gather of every
  worker's state leaves packed as 32-bit words.

Every collective goes through :func:`_all_reduce` or :func:`_all_gather`,
which count their calls (:func:`collective_counts`, read like
``kernels/ops.launch_counts``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as tdist

from repro_torch import prng
from repro_torch.core import error as err
from repro_torch.core import oasrs
from repro_torch.core import quantile as qt
from repro_torch.core import sketches as sk

_MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The collectives, counted.
# ---------------------------------------------------------------------------

def _all_reduce(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``buf`` over the group's ranks, in place (one collective)."""
    tdist.all_reduce(buf, op=tdist.ReduceOp.SUM, group=group)
    _all_reduce.calls += 1
    return buf


def _all_gather(buf: torch.Tensor, group=None) -> torch.Tensor:
    """``[world·R, C]``: every rank's ``[R, C]`` buffer in rank order (one
    collective)."""
    world = tdist.get_world_size(group)
    out = torch.empty((world * buf.shape[0],) + tuple(buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    # torch 2.13 deprecates ``all_gather_into_tensor`` for
    # ``all_gather_single``; torch 2.11 (the H100 build, 2.11.0+cu128,
    # that runs the port's NCCL path) has only ``all_gather_into_tensor``.
    gather = getattr(tdist, "all_gather_single", None) or \
        tdist.all_gather_into_tensor
    gather(out, buf.contiguous(), group=group)
    _all_gather.calls += 1
    return out


_all_reduce.calls = 0
_all_gather.calls = 0


def collective_counts() -> dict:
    """Collectives this module performed since the last reset."""
    return {"all_reduce": _all_reduce.calls, "all_gather": _all_gather.calls}


def reset_collective_counts() -> None:
    _all_reduce.calls = 0
    _all_gather.calls = 0


def _psum(parts: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum a tuple of f32 tensors over the ranks with ONE all_reduce of
    their packed concatenation; returns them in their own shapes."""
    flat = torch.cat([p.to(torch.float32).reshape(-1) for p in parts])
    _all_reduce(flat, group)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    return out


# ---------------------------------------------------------------------------
# The ingest and the linear merges.
# ---------------------------------------------------------------------------

def local_update(state: oasrs.OASRSState, stratum_ids: torch.Tensor,
                 payload,
                 mask: Optional[torch.Tensor] = None) -> oasrs.OASRSState:
    """Per-shard ingestion: just the local chunk fold (``payload`` a tree
    of ``[M, ...]`` leaves), no collective. The fold runs where the state
    lies (``kernels/ops``), so the reference's ``backend=`` has no
    counterpart."""
    return oasrs.update_chunk(state, stratum_ids, payload, mask)


def _alive(alive, like: torch.Tensor) -> torch.Tensor:
    if alive is None:
        return torch.ones((), dtype=torch.float32, device=like.device)
    return torch.as_tensor(alive, device=like.device).to(torch.float32)


def _merge_partials(local: err.Estimate, group,
                    alive=None) -> err.Estimate:
    a = _alive(alive, local.value)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    val, var, n_alive, n_total = _psum(
        (a * local.value, a * a * local.variance, a, one), group)
    inflate = n_total / torch.clamp(n_alive, min=1.0)
    # Dropping shards multiplies the estimator by w / w_alive: the
    # variance of the inflated estimator picks up inflate² on the
    # surviving partials.
    return err.Estimate(value=val * inflate,
                        variance=var * inflate * inflate)


def global_sum(local_stats: err.StratumStats, group=None,
               alive=None) -> err.Estimate:
    """Merge per-shard partial SUM estimates with one all_reduce.

    ``alive``: 0 or 1 for this shard (1 = met the window deadline).
    """
    return _merge_partials(err.estimate_sum(local_stats), group, alive)


def global_mean(local_stats: err.StratumStats, group=None,
                alive=None) -> err.Estimate:
    """Merge per-shard partials into the global MEAN estimate: the SUM,
    its variance and the item count ride one all_reduce."""
    local_sum = err.estimate_sum(local_stats)
    local_count = torch.sum(local_stats.counts).to(torch.float32)
    a = _alive(alive, local_sum.value)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    num, var, cnt, n_alive, n_total = _psum(
        (a * local_sum.value, a * a * local_sum.variance, a * local_count,
         a, one), group)
    inflate = n_total / torch.clamp(n_alive, min=1.0)
    total = torch.clamp(cnt * inflate, min=1.0)
    # Var(MEAN) = Var(SUM) / total² for the stratified estimator.
    return err.Estimate(value=num * inflate / total,
                        variance=var * inflate * inflate / (total * total))


# ---------------------------------------------------------------------------
# Nonlinear queries: one all_reduce per merge of per-shard partials.
# ---------------------------------------------------------------------------

def global_histogram(view: qt.SampleView, edges: torch.Tensor, group=None,
                     alive=None) -> err.Estimate:
    """Merge per-shard per-bin COUNT estimates (Eq. 6 per bin) with one
    all_reduce; ``view`` is the shard's local merged view."""
    return _merge_partials(qt.cell_counts(view, edges), group, alive)


def global_key_counts(view: qt.SampleView, keys: torch.Tensor, group=None,
                      alive=None) -> err.Estimate:
    """Merge per-shard per-key COUNT estimates (heavy hitters' phase 2)
    with one all_reduce. ``keys`` must be the same on every shard."""
    return _merge_partials(sk.key_counts(view, keys), group, alive)


def _binned(values: torch.Tensor, w: torch.Tensor, valid: torch.Tensor,
            edges: torch.Tensor):
    """HT-weighted mass per fine bin of ``values [R, G, N]`` (one row per
    replicate), the mass below ``edges[0]`` and the total: ``[R, B]``,
    ``[R]``, ``[R]``.

    Bin ``b`` is ``[edges[b], edges[b+1])`` and the last bin is
    right-closed (the histogram kernel's convention). ``G·B`` exceeds the
    kernel's shared-memory table at 2048 bins, so, like the reference
    (``use_pallas=False``), this bins outside the kernel: each slot's bin
    by ``bucketize``, the masses summed in f64 and rounded once.
    """
    reps, nb = values.shape[0], edges.shape[0] - 1
    x = values.reshape(reps, -1)
    wv = torch.where(valid, w, 0.0).reshape(-1)
    b = torch.bucketize(x, edges, right=True) - 1
    b = torch.where(x == edges[-1], nb - 1, b)
    inb = valid.reshape(-1) & (b >= 0) & (b < nb)
    row = torch.arange(reps, device=x.device)[:, None] * nb
    hist = torch.zeros(reps * nb, dtype=torch.float64, device=x.device)
    hist.index_add_(0, torch.where(inb, b + row, 0).reshape(-1),
                    torch.where(inb, wv, 0.0).double().reshape(-1))
    below = torch.sum(torch.where(x < edges[0], wv, 0.0), dim=-1)
    total = torch.sum(wv, dim=-1).expand(reps)
    return hist.view(reps, nb).to(torch.float32), below, total


def global_quantile(view: qt.SampleView, qs, value_range, group=None,
                    num_bins: int = 2048, num_replicates: int = 0,
                    key: Optional[torch.Tensor] = None) -> err.Estimate:
    """Global quantiles from per-shard weighted histograms, one all_reduce.

    Each shard bins its HT-weighted sample over the (shared)
    ``value_range = (lo, hi)`` into ``num_bins`` fine bins; the one
    all_reduce merges the ``[R+1, B]`` histograms (replicate 0 is the
    sample, the rest stratified-bootstrap resamples), the mass below the
    range and the total weight. Every shard then inverts the same global
    CDF. Mass outside the range still counts in ``below``/``total``;
    targets beyond it clamp to its edges.
    """
    dev = view.values.device
    qs = torch.as_tensor(qs, dtype=torch.float32, device=dev).reshape(-1)
    lo, hi = (float(v) for v in value_range)
    lin = torch.linspace(0.0, 1.0, num_bins + 1, dtype=torch.float32,
                         device=dev)
    edges = lo + (hi - lo) * lin
    g, n = view.values.shape
    w = view.weights()[:, None].expand(g, n)
    valid = view.slot_mask()
    samples = view.values[None]
    if num_replicates > 0:
        if key is None:
            raise ValueError("pass key= for bootstrap replicates")
        # One draw for every replicate: the keys' leading axis is the
        # replicate, each resampling every cell within its own taken.
        keys = prng.split(key, num_replicates)
        idx = prng.randint(keys, (g, n), 0,
                           torch.clamp(view.taken, min=1)[:, None])
        reps = torch.gather(view.values.expand(num_replicates, g, n), 2,
                            idx.long())
        samples = torch.cat([samples, reps])
    hists, belows, totals = _binned(samples, w, valid, edges)
    g_hist, g_below, g_total = _psum((hists, belows, totals), group)
    values = torch.stack([
        qt.invert_weighted_cdf(g_hist[r], edges, g_below[r],
                               qs * torch.clamp(g_total[r], min=1e-20))
        for r in range(g_hist.shape[0])])                     # [R+1, Q]
    variance = (torch.var(values[1:], dim=0, correction=1)
                if num_replicates > 1 else torch.zeros_like(values[0]))
    return err.Estimate(value=values[0], variance=variance)


def sts_global_counts(local_counts: torch.Tensor,
                      group=None) -> torch.Tensor:
    """The STS baseline's pass-1 synchronization barrier (one all_reduce
    of the per-stratum counts), to contrast with the collective-free
    OASRS ingest."""
    return _all_reduce(local_counts.clone(), group)


def split_capacity(total_capacity: torch.Tensor,
                   num_shards: int) -> torch.Tensor:
    """Per-worker reservoir size ``N_i / w`` (ceil, so Σ >= N_i; at
    least 1)."""
    c = torch.as_tensor(total_capacity).to(torch.int32)
    return torch.clamp((c + num_shards - 1) // num_shards,
                       min=1).to(torch.int32)


# ---------------------------------------------------------------------------
# The mesh emission merge.
# ---------------------------------------------------------------------------

def _as_f32(words: torch.Tensor) -> torch.Tensor:
    """Integer words (i32, or u32 held in i64) as f32 bit patterns."""
    return words.to(torch.int32).contiguous().view(torch.float32)


def gather_cells(view: qt.SampleView, aux: torch.Tensor, group=None,
                 num_shards: Optional[int] = None):
    """The mesh emission merge: ONE all_gather per emission.

    Each rank holds its shard's local merged view (``values [G, N]`` f32,
    ``counts``/``taken [G]`` i32) and ``aux``, a flat vector of u32 words
    (int64 tensor) the emission needs from every shard. One all_gather
    concatenates the ranks in rank order, which is bitwise the vmap
    placement's ``[W, G, N] → [W·G, N]`` view, with ``aux`` riding in
    padded tail rows of the same buffer. Integer words travel as their
    bit patterns (``view(torch.float32)`` of i32), never cast, so words
    above ``2**24`` stay exact.

    Returns ``(merged view [W·G, N], aux_all [W, A])``, ``aux_all`` as
    int64 u32 words.
    """
    world = tdist.get_world_size(group)
    if num_shards is not None and world != num_shards:
        raise ValueError(f"gather_cells: the process group has {world} "
                         f"ranks, the view {num_shards} shards")
    g, n = view.values.shape
    width = n + 2
    packed = torch.cat([view.values.to(torch.float32),
                        _as_f32(view.counts)[:, None],
                        _as_f32(view.taken)[:, None]], dim=1)  # [G, N+2]
    a = aux.shape[0]
    rows = -(-a // width)
    tail = torch.zeros(rows * width, dtype=torch.float32,
                       device=packed.device)
    tail[:a] = _as_f32(aux)
    packed = torch.cat([packed, tail.view(rows, width)])     # [G+rows, N+2]
    gathered = _all_gather(packed, group).view(world, g + rows, width)
    cells = gathered[:, :g].reshape(world * g, width)
    merged = qt.SampleView(
        values=cells[:, :n],
        counts=cells[:, n].contiguous().view(torch.int32),
        taken=cells[:, n + 1].contiguous().view(torch.int32))
    aux_all = gathered[:, g:].reshape(world, rows * width)[:, :a]
    aux_all = aux_all.contiguous().view(torch.int32).to(torch.int64) & _MASK
    return merged, aux_all


def gather_shards(parts: Sequence[torch.Tensor],
                  group=None) -> List[torch.Tensor]:
    """Stack every rank's ``[1, ...]`` tensors into ``[world, ...]`` ones
    with ONE all_gather of one packed buffer of 32-bit words (a mesh
    checkpoint's capture). Each part keeps its dtype and its bits: f32
    and i32 travel as their bit patterns, int64 as the u32 words it
    holds (PRNG key words)."""
    words = []
    for p in parts:
        p = p.reshape(1, -1)
        if p.dtype == torch.float32:
            p = p.contiguous().view(torch.int32)
        words.append(p.to(torch.int32))
    gathered = _all_gather(torch.cat(words, dim=1), group)
    out, at = [], 0
    for p in parts:
        n = p[0].numel()
        w = gathered[:, at:at + n]
        at += n
        if p.dtype == torch.float32:
            w = w.contiguous().view(torch.float32)
        elif p.dtype == torch.int64:
            w = w.to(torch.int64) & _MASK
        out.append(w.reshape((w.shape[0],) + tuple(p.shape[1:])))
    return out
