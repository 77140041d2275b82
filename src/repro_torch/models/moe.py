"""Mixture-of-Experts FFN with sort-based (dropless-style) dispatch.

Counterpart of the reference's ``models/moe.py``. Dispatch is the
*stratified sampling* problem in disguise: experts are strata, the router
assigns each token to k strata, and the per-expert capacity ``C`` is a
reservoir. Two overflow policies:

* ``positional`` (default, GShard-compatible): tokens beyond capacity are
  dropped in sequence order;
* ``reservoir`` (``cfg.reservoir_routing``): overflow is resolved by a
  random permutation inside each expert's assignment list, so every token
  of an overloaded expert has equal survival probability; surviving gates
  are re-inflated by ``n_i/C`` (the OASRS weight).

The dispatch plan is the reference's bit for bit on the CPU: the top-k
is a stable descending sort (ties to the lower expert, as
``jax.lax.top_k``), the reservoir's uniforms are ``prng``'s (the
reference's ``split`` / ``uniform`` words), the ranks a stable sort. The
groups (batch rows in training and prefill, the whole batch in decode)
are one tensor axis where the reference vmaps. The combine sums each
token's k contributions in the reference's scatter order (k = 0, 1, ...
onto zeros), as a gather: the card's ``index_add_`` adds in atomic
order and would change bf16 outputs from run to run. The reference's
expert-parallel sharding annotations are kept (no-ops without a mesh).
Under a mesh the dispatch plan, the scatter into the expert buffers and
the combine run shard-local on each rank's groups
(``sharding.on_batch_shards``),
as the reference's comment has them, and the expert products run on the
buffers placed over ``experts`` / ``expert_mlp``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec
from repro_torch.utils import rank_within_stratum


def moe_skeleton(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    skel = {
        "router": ParamSpec((d, e), ("embed_tp", "experts"),
                            dtype=torch.float32),
        "w_in": ParamSpec((e, d, f), ("experts", "embed_tp", "expert_mlp"),
                          dtype=cfg.dtype),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed_tp", "expert_mlp"),
                            dtype=cfg.dtype),
        "w_out": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed_tp"),
                           dtype=cfg.dtype),
    }
    if cfg.num_shared_experts:
        fs = cfg.expert_d_ff * cfg.num_shared_experts
        skel["shared"] = {
            "w_in": ParamSpec((d, fs), ("embed_tp", "mlp"), dtype=cfg.dtype),
            "w_gate": ParamSpec((d, fs), ("embed_tp", "mlp"),
                                dtype=cfg.dtype),
            "w_out": ParamSpec((fs, d), ("mlp", "embed_tp"), dtype=cfg.dtype),
        }
    return skel


def capacity_of(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert and group: the reference's Python arithmetic."""
    return max(int(tokens_per_group * cfg.num_experts_per_token
                   * cfg.capacity_factor / cfg.num_experts), 4)


def _group_ranks(ids: torch.Tensor, num: int) -> torch.Tensor:
    """Rank of each entry of ``ids [G, A]`` (values in ``[0, num)``) among
    the earlier equal entries of its row: ``rank_within_stratum`` of each
    row, as one call over ids offset by ``num`` per row."""
    g, a = ids.shape
    rows = torch.arange(g, dtype=torch.int64, device=ids.device)[:, None]
    flat = (ids.long() + rows * num).reshape(-1)
    return rank_within_stratum(flat).view(g, a)


def _dispatch_indices(eids: torch.Tensor, gates: torch.Tensor,
                      capacity: int, num_experts: int,
                      keys: Optional[torch.Tensor]):
    """Per-group dispatch plan. eids (int32) / gates (f32): ``[G, A]``
    flat assignments; ``keys``: ``[G, 2]`` for the reservoir policy, None
    for the positional one.

    Returns (dst slot in ``[0, E·C]`` int32, E·C the overflow slot; keep
    mask; gate scale), each ``[G, A]``.
    """
    overflow = num_experts * capacity
    if keys is None:
        rank = _group_ranks(eids, num_experts)
        keep = rank < capacity
        dst = torch.where(keep, eids * capacity + rank, overflow)
        return dst, keep, gates
    # Reservoir overflow policy: rank assignments inside each expert by a
    # random permutation instead of arrival order → uniform survival.
    u = prng.uniform(keys, eids.shape[-1])                    # [G, A] f32
    order = torch.argsort(eids.to(torch.float32) + u * 0.5, dim=-1,
                          stable=True)
    rank_shuffled = _group_ranks(torch.gather(eids, 1, order), num_experts)
    rank = torch.empty_like(rank_shuffled).scatter_(1, order, rank_shuffled)
    keep = rank < capacity
    dst = torch.where(keep, eids * capacity + rank, overflow)
    # HT re-inflation: surviving gates represent n_i/C originals.
    n_per = torch.zeros(eids.shape[0], num_experts, dtype=torch.float32,
                        device=eids.device).scatter_add_(
        1, eids.long(), torch.ones_like(gates))
    scale = torch.gather(torch.clamp(n_per / capacity, min=1.0), 1,
                         eids.long())
    return dst, keep, gates * scale


def route(params: dict, xg: torch.Tensor, cfg: ModelConfig,
          key: Optional[torch.Tensor] = None):
    """The router and the dispatch plan of ``xg [G, T, D]``: ``(eids,
    gates, dst, keep, gate scale)``, the last three ``[G, T·k]``. ``key``:
    the reservoir policy's base key, or ``[G, 2]`` keys, one per group."""
    g, tg, _ = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    logits = xg.float() @ params["router"]                    # [G, T, E]
    # jax.nn.softmax: exp(x - max) / sum.
    ex = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = ex / torch.sum(ex, dim=-1, keepdim=True)
    # jax.lax.top_k: the k largest, ties to the lower index.
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[..., :k], eids[..., :k].to(torch.int32)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True),
                                min=1e-9)
    keys = None
    if cfg.reservoir_routing:
        base = key if key is not None else prng.PRNGKey(0, xg.device)
        # a [G, 2] key is already one key per group
        keys = base if base.dim() == 2 else prng.split(base, g)
    dst, keep, gsc = _dispatch_indices(
        eids.reshape(g, tg * k), gates.reshape(g, tg * k),
        capacity_of(cfg, tg), e, keys)
    return eids, gates, dst, keep, gsc


def _experts(params: dict, xbuf: torch.Tensor) -> torch.Tensor:
    """Per-expert gated FFN of ``xbuf [G, E, C, D]``, one batched product
    per weight over experts → ``[G, E·C, D]``."""
    groups, e, capacity, d = xbuf.shape
    xe = xbuf.transpose(0, 1).reshape(e, groups * capacity, d)
    h = shard(torch.bmm(xe, params["w_in"]), "experts", "batch",
              "expert_mlp")
    h = F.silu(torch.bmm(xe, params["w_gate"])) * h
    ye = shard(torch.bmm(h, params["w_out"]), "experts", "batch", None)
    return ye.view(e, groups, capacity, d).transpose(0, 1).reshape(
        groups, e * capacity, d)


def _local_experts(params: dict, xbuf) -> torch.Tensor:
    """:func:`_experts` on each rank's groups and experts (``xbuf``
    placed ``("batch", "experts", None, None)``, the weights by their
    logical axes): the result is sharded like ``xbuf`` on its groups and
    on the ``E·C`` dim where experts are sharded, and a pending sum where
    ``expert_mlp`` splits the hidden dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    w_in = params["w_in"]
    mesh = w_in.device_mesh
    out = []
    for xp, wp in zip(xbuf.placements, w_in.placements):
        if isinstance(xp, Shard):
            out.append(xp)
        elif isinstance(wp, Shard) and wp.dim == 2:
            out.append(Partial())
        else:
            out.append(Replicate())
    with shd.local_region():
        y = _experts({k: shd.local(params[k], out)
                      for k in ("w_in", "w_gate", "w_out")},
                     shd.local(xbuf, out))
    groups, e, capacity, d = xbuf.shape
    return shd.from_local(y, (groups, e * capacity, d), mesh, out)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
            key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MoE FFN. x: ``[B, S, D]`` (training / prefill, one group per batch
    row) or ``[B, 1, D]`` (decode, the whole batch one group)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    groups, tg = (b, s) if s > 1 else (1, b)
    xg = x.reshape(groups, tg, d)
    capacity = capacity_of(cfg, tg)
    def dispatch(g0, xg, router):
        gkey = key
        if cfg.reservoir_routing and xg.shape[0] != groups:
            base = key if key is not None else prng.PRNGKey(0, xg.device)
            gkey = prng.split(base, groups)[g0:g0 + xg.shape[0]]
        _, _, dst, keep, gsc = route({"router": router}, xg, cfg, gkey)
        # Scatter the tokens into per-expert buffers [G, E·C (+1 overflow
        # row), D]: token t's k assignments are entries t·k ... t·k + k - 1.
        # Kept assignments have distinct slots; the dropped ones all land
        # on the overflow row, which is cut off.
        xa = xg.repeat_interleave(k, dim=1)                   # [G, T·k, D]
        buf = torch.zeros(xg.shape[0], e * capacity + 1, d, dtype=x.dtype,
                          device=x.device)
        buf = buf.scatter(1, dst.long()[..., None].expand(-1, -1, d), xa)
        # the overflow row cut off on the rank: on a mesh, the backward of
        # a view that splits the E·C dim fails where the experts do not
        # divide evenly over ``model`` (its grad is a pending sum there)
        return buf[:, :-1].reshape(xg.shape[0], e, capacity, d), dst, \
            keep, gsc

    xbuf, dst, keep, gsc = shd.on_batch_shards(dispatch, groups, xg,
                                               whole=(params["router"],))
    xbuf = shard(xbuf, "batch", "experts", None, None)

    if isinstance(xbuf, shd.DTensor):
        ybuf = _local_experts(params, xbuf)
    else:
        ybuf = _experts(params, xbuf)
    ybuf = shard(ybuf, "batch", None, None)

    def combine(_g0, ybuf, dst, keep, gsc):
        # Gather back, weight, and add each token's k contributions in
        # order.
        slot = torch.clamp(dst, max=e * capacity - 1).long()
        ya = torch.gather(ybuf, 1, slot[..., None].expand(-1, -1, d))
        w = (gsc * keep.to(torch.float32)).to(ya.dtype)
        contrib = (ya * w[..., None]).view(ybuf.shape[0], tg, k, d)
        y = torch.zeros(ybuf.shape[0], tg, d, dtype=contrib.dtype,
                        device=x.device)
        for j in range(k):
            y = y + contrib[:, :, j]
        return y

    y = shd.on_batch_shards(combine, groups, ybuf, dst, keep,
                              gsc).reshape(b, s, d)
    if cfg.num_shared_experts:
        sh = params["shared"]
        hs = F.silu(x @ sh["w_gate"]) * (x @ sh["w_in"])
        y = y + hs @ sh["w_out"]
    return shard(y.to(x.dtype), "batch", None, "embed")


def load_balancing_loss(probs: torch.Tensor, eids: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Standard auxiliary loss: E · Σ_e f_e · p_e (Switch-style)."""
    p_mean = torch.mean(probs.reshape(-1, num_experts), dim=0)
    onehot = F.one_hot(eids.reshape(-1).long(), num_experts).to(
        torch.float32)
    f = torch.mean(onehot, dim=0)
    return num_experts * torch.sum(f * p_mean)
