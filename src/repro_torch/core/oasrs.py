"""Online Adaptive Stratified Reservoir Sampling (OASRS), paper §3.2.

Counterpart of the reference's ``core/oasrs.py``: the state, whose
payload is one ``[S, N_max, ...]`` reservoir tensor or a tree (dicts,
tuples, lists) of them described by a tree of :class:`PayloadSpec`, its
fresh-buffer ``init``, ``reset_window``, and the paper's two ingestion
models with the reference's key schedules:

* ``update_chunk`` — the batched model (Spark Streaming): the key is
  split three ways and two ``[M]`` uniforms are drawn up front. The fold
  runs where the tensors lie (``kernels/ops``): the CUDA kernel on the
  card, the plain version on the CPU; both consume the same draws.
* ``update_item`` / ``update_stream`` — the pipelined model (Flink),
  Algorithm 1 one item at a time: a Python loop of device operations
  with no host read, for the tests and short runs, not a throughput
  path. ``update_pipelined_chunks`` folds ``lane`` items per
  ``update_chunk``, so through the fold kernel on the card; its result
  depends on ``lane``.

Unlike the reference's pure updates, the fold writes the reservoir
tensors IN PLACE (the ring is never re-materialised per chunk); the
returned state shares ``values`` with the input state. A payload whose
structure is not the state's raises ``ValueError``, as the reference's
``jax.tree.map`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import prng
from repro_torch.kernels import ops
from repro_torch.utils import (DeviceLike, resolve_device, tree_flatten,
                               tree_map)


@dataclasses.dataclass(frozen=True)
class PayloadSpec:
    """One item's payload leaf, the reference's ``jax.ShapeDtypeStruct``:
    its reservoir leaf is ``[S, N_max, *shape]`` of ``dtype``."""
    shape: tuple = ()
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class OASRSState:
    """Per-window sampling state.

    values:   ``[S, N_max, ...]`` reservoir payloads, or a tree of them.
    counts:   ``[S]`` int32 — ``C_i``, arrivals per stratum this window.
    capacity: ``[S]`` int32 — ``N_i <= N_max``, the adaptive knob.
    key:      ``[2]`` int64 PRNG key (two u32 words).
    """
    values: torch.Tensor
    counts: torch.Tensor
    capacity: torch.Tensor
    key: torch.Tensor

    @property
    def num_strata(self) -> int:
        return self.counts.shape[-1]

    @property
    def max_capacity(self) -> int:
        """``N_max``: the first values leaf's axis after the strata."""
        return tree_flatten(self.values)[0][0].shape[self.counts.dim()]

    def taken(self) -> torch.Tensor:
        """``Y_i = min(C_i, N_i)``."""
        return torch.minimum(self.counts, self.capacity)

    def weights(self) -> torch.Tensor:
        """Eq. 1: ``W_i = C_i/N_i`` if ``C_i > N_i`` else 1."""
        c = self.counts.to(torch.float32)
        n = torch.clamp(self.capacity, min=1).to(torch.float32)
        return torch.where(self.counts > self.capacity, c / n, 1.0)

    def slot_mask(self) -> torch.Tensor:
        """``[S, N_max]`` bool — which slots hold sampled items."""
        slots = torch.arange(self.max_capacity, dtype=torch.int32,
                             device=self.counts.device)
        return slots < self.taken()[..., None]


def init(num_strata: int, capacity, key: torch.Tensor,
         max_capacity: Optional[int] = None,
         payload_spec=PayloadSpec(),
         device: DeviceLike = None) -> OASRSState:
    """Empty state; ``capacity`` is an int or ``[S]`` ints.

    ``payload_spec`` describes ONE item's payload: a :class:`PayloadSpec`
    (the default, a scalar f32) or a tree of them; each leaf becomes a
    zero ``[S, N_max, *shape]`` buffer. ``capacity`` always gets a FRESH
    buffer, never a view of the caller's tensor: the state is updated in
    place later.
    """
    dev = resolve_device(device)
    cap = torch.as_tensor(capacity, dtype=torch.int32)
    if max_capacity is None:
        max_capacity = int(cap.max())
    cap = cap.to(dev).expand(num_strata).clone()
    return OASRSState(
        values=tree_map(lambda sp: torch.zeros(
            (num_strata, max_capacity) + tuple(sp.shape), dtype=sp.dtype,
            device=dev), payload_spec),
        counts=torch.zeros(num_strata, dtype=torch.int32, device=dev),
        capacity=cap,
        key=key.to(dev))


def apply_chunk_uniforms(state: OASRSState, stratum_ids: torch.Tensor,
                         payload, mask: torch.Tensor,
                         u_accept: torch.Tensor,
                         u_slot: torch.Tensor) -> OASRSState:
    """The chunk fold given pre-drawn uniforms; ``state.key`` is kept.

    Bit-identical to folding the chunk item by item through Algorithm 1
    with the same uniforms. ``payload`` is a tree of ``[M, ...]`` leaves
    with the structure of ``state.values``, which is written in place.
    """
    counts = ops.reservoir_fold(stratum_ids.to(torch.int32), payload,
                                u_accept, u_slot, mask, state.counts,
                                state.capacity, state.values)
    return OASRSState(values=state.values, counts=counts,
                      capacity=state.capacity, key=state.key)


def update_chunk(state: OASRSState, stratum_ids: torch.Tensor, payload,
                 mask: Optional[torch.Tensor] = None) -> OASRSState:
    """Fold a micro-batch of ``M`` items (``payload`` a tree of ``[M,
    ...]`` leaves) into the reservoirs."""
    m = stratum_ids.shape[0]
    if mask is None:
        mask = torch.ones(m, dtype=torch.bool, device=stratum_ids.device)
    keys = prng.split(state.key, 3)
    # Both draws in one hash over the two keys: the same bits as two
    # draws, half the host launches.
    u_accept, u_slot = prng.uniform(keys[1:3], m)
    out = apply_chunk_uniforms(state, stratum_ids, payload, mask, u_accept,
                               u_slot)
    return dataclasses.replace(out, key=keys[0])


def reset_window(state: OASRSState) -> OASRSState:
    """Start a new window: zero the counters (the reservoir's contents
    are dead, since ``slot_mask`` derives from the counts)."""
    return dataclasses.replace(state, counts=torch.zeros_like(state.counts))


# ---------------------------------------------------------------------------
# Pipelined-model ingestion (Flink analog).
# ---------------------------------------------------------------------------

def _fold_item(state: OASRSState, s: torch.Tensor, payload,
               mk: torch.Tensor, u: torch.Tensor,
               slot_draw: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 for one item given its draws (``u`` for acceptance,
    ``slot_draw`` the replacement slot); ``s``, ``mk``, ``u`` and
    ``slot_draw`` are ``[1]`` tensors, since indexing with a 0-dim tensor
    reads it back to the host, and ``payload`` a tree of one item's
    leaves. Writes every reservoir leaf in place; returns the new
    counts."""
    c = state.counts.index_select(0, s) + 1
    cap = state.capacity.index_select(0, s)
    filling = c <= cap
    accept = mk & (filling | (u * c.to(torch.float32)
                              < cap.to(torch.float32)))
    slot = torch.where(filling, c - 1, slot_draw)
    cell = s * state.max_capacity + slot.long()

    def write(res_leaf, pay_leaf):
        rows = res_leaf.view(-1, *res_leaf.shape[2:])
        old = rows.index_select(0, cell)
        rows.index_copy_(0, cell, torch.where(
            accept.view((1,) * old.dim()),
            pay_leaf.reshape(old.shape).to(rows.dtype), old))
    tree_map(write, state.values, payload)
    return state.counts.index_add(0, s, mk.to(torch.int32))


def update_item(state: OASRSState, stratum_id: torch.Tensor, payload,
                mask=True) -> OASRSState:
    """Algorithm 1 applied to one arriving item (pipelined operator).

    ``stratum_id`` is a one-element tensor, ``payload`` a tree of the
    item's leaves (``[*shape]`` or ``[1, *shape]`` each), ``mask`` a bool
    or a one-element bool tensor. The key splits three ways: the next
    key, an acceptance uniform and a replacement slot ``randint(0,
    max(N_i, 1))``. The reservoir is written in place; ``counts`` is a
    new tensor."""
    keys = prng.split(state.key, 3)
    s = stratum_id.reshape(1).long()
    mk = (mask if isinstance(mask, torch.Tensor) else torch.full(
        (), bool(mask), device=state.counts.device)).reshape(1)
    cap = torch.clamp(state.capacity.index_select(0, s), min=1)
    # A draw of shape (1,) is the reference's draw of shape ().
    counts = _fold_item(state, s, payload, mk, prng.uniform(keys[1], 1),
                        prng.randint(keys[2], 1, 0, cap))
    return OASRSState(values=state.values, counts=counts,
                      capacity=state.capacity, key=keys[0])


def update_stream(state: OASRSState, stratum_ids: torch.Tensor, payload,
                  mask: Optional[torch.Tensor] = None) -> OASRSState:
    """Pipelined ingestion of ``T`` items (``payload`` a tree of ``[T,
    ...]`` leaves), one at a time: each item flows through the sampler as
    it arrives; no batch is formed first.

    :func:`update_item`'s draws for every item at once: the key chain is
    walked first (item ``j``'s keys are ``split(key_j, 3)``, ``key_{j+1}``
    the first of them), then one batched uniform and one batched
    ``randint`` over the ``[T, 2]`` keys (the capacity does not change
    within the stream), then the items are folded in order."""
    t = stratum_ids.shape[0]
    if mask is None:
        mask = torch.ones(t, dtype=torch.bool, device=stratum_ids.device)
    key, chain = state.key, []
    for _ in range(t):
        keys = prng.split(key, 3)
        chain.append(keys)
        key = keys[0]
    if not chain:
        return state
    chain = torch.stack(chain)                        # [T, 3, 2]
    sid = stratum_ids.reshape(t).long()
    u = prng.uniform(chain[:, 1], 1)                  # [T, 1]
    cap = torch.clamp(state.capacity.index_select(0, sid), min=1)
    slots = prng.randint(chain[:, 2], 1, 0, cap[:, None])
    for j in range(t):
        counts = _fold_item(state, sid[j:j + 1],
                            tree_map(lambda p: p[j:j + 1], payload),
                            mask[j:j + 1], u[j], slots[j])
        state = OASRSState(values=state.values, counts=counts,
                           capacity=state.capacity, key=state.key)
    return dataclasses.replace(state, key=key)


def update_pipelined_chunks(state: OASRSState, stratum_ids: torch.Tensor,
                            payload, lane: int = 64,
                            mask: Optional[torch.Tensor] = None
                            ) -> OASRSState:
    """Pipelined ingestion ``lane`` items at a time: one
    :func:`update_chunk` per lane, in stream order (the reference's
    Flink mode, ``lax.scan`` over the lanes)."""
    t = stratum_ids.shape[0]
    if t % lane != 0:
        raise ValueError(f"stream length {t} not divisible by lane {lane}")
    if mask is None:
        mask = torch.ones(t, dtype=torch.bool, device=stratum_ids.device)
    for i in range(0, t, lane):
        state = update_chunk(state, stratum_ids[i:i + lane],
                             tree_map(lambda p: p[i:i + lane], payload),
                             mask[i:i + lane])
    return state


# ---------------------------------------------------------------------------
# Sample extraction.
# ---------------------------------------------------------------------------

def sample_with_weights(
    state: OASRSState,
    extract: Callable[[object], torch.Tensor] = lambda p: p,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(x, w, valid)`` flattened over all reservoir slots: slot ``k``'s
    extracted value (``extract`` maps the values tree to ``[S, N_max]``),
    its stratum's weight ``W_i`` and whether it holds a sampled item."""
    xs = extract(state.values)
    w = state.weights()[..., None].expand(xs.shape)
    return (xs.reshape(-1), w.reshape(-1),
            state.slot_mask().reshape(-1))
