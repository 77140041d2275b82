"""Attention: GQA with interleaved RoPE, chunked online-softmax attention
for prefill, and one-token decode against a KV cache.

Counterpart of the reference's ``models/attention.py``, block for block:

* **Grouped-native GQA.** Q lives as ``[B, S, Hkv, G, hd]`` (G = Hq/Hkv)
  and the Q projection is 4-D ``[d, Hkv, G, hd]``; KV tensors are never
  repeated in memory.
* **RoPE is interleaved** (adjacent-pair rotation).
* Prefill attention never materialises the full ``S × S`` scores: a
  Python loop over query blocks (exact causal block range) × a loop over
  KV blocks with a running online softmax, in the reference's order.
  Scores and ``P·V`` are f32 out of bf16 operands, as the reference's
  ``preferred_element_type=jnp.float32`` dots (``layers.dot_f32``).

No finished attention kernel is used (``scaled_dot_product_attention``
would change the softmax's order and its numbers). Under a mesh whose
rules shard the query sequence (``get_rule("attn_seq")``, the reference's
sequence-parallel mode) the query block is the whole sequence, as the
reference's, and each rank projects q, k and v from its part of the
sequence, k and v then gathered along it, as XLA partitions the
reference's program; otherwise the block is ``min(attn_q_chunk, S)``.
The reference's
sharding annotations are kept (no-ops without a mesh).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import (DTensor, get_rule,
                                              local_shape_and_offset, shard)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dot_f32, scalar_in
from repro_torch.models.param import ParamSpec

NEG_INF = -1e30
Q_LOGICAL = ("batch", "attn_seq", "kv_heads", "q_group", "head_dim_tp")
KV_LOGICAL = ("batch", None, "kv_heads", "head_dim_tp")


def attention_skeleton(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    return {
        "wq": ParamSpec((d, hkv, g, hd),
                        ("embed_tp", "kv_heads", "q_group", "head_dim_tp"),
                        dtype=cfg.dtype),
        "wk": ParamSpec((d, hkv, hd),
                        ("embed_tp", "kv_heads", "head_dim_tp"),
                        dtype=cfg.dtype),
        "wv": ParamSpec((d, hkv, hd),
                        ("embed_tp", "kv_heads", "head_dim_tp"),
                        dtype=cfg.dtype),
        "wo": ParamSpec((hkv, g, hd, d),
                        ("kv_heads", "q_group", "head_dim_tp", "embed_tp"),
                        dtype=cfg.dtype),
    }


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Interleaved RoPE: rotate adjacent pairs ``(x[2i], x[2i+1])``.

    x: ``[..., S, heads..., hd]``; positions: ``[S]`` (any int dtype, on
    x's device). f32 angles, ``cos`` and ``sin`` as the reference's (not
    bitwise: XLA's and torch's ``pow``, ``cos`` and ``sin`` differ in
    the last ulp)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.full_like(exps, float(theta)), exps)
    ang = positions.float()[..., None] * freqs          # [..., S, half]
    extra = x.dim() - ang.dim() - 1
    ang = ang.reshape(ang.shape[:-1] + (1,) * extra + (half,))
    cos, sin = torch.cos(ang), torch.sin(ang)
    xp = x.float().reshape(x.shape[:-1] + (half, 2))
    x1, x2 = xp[..., 0], xp[..., 1]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.reshape(x.shape).to(x.dtype)


def qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
        cfg: ModelConfig, use_rope: bool = True):
    """x: ``[B, S, D]`` → q ``[B,S,Hkv,G,hd]``, k/v ``[B,S,Hkv,hd]``."""
    if isinstance(x, DTensor) and get_rule("attn_seq") is not None:
        out = _seq_parallel_qkv(params, x, positions, cfg, use_rope)
        if out is not None:
            return out
    q, k, v = (project(x, params[w]) for w in ("wq", "wk", "wv"))
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return (shard(q, *Q_LOGICAL), shard(k, *KV_LOGICAL),
            shard(v, *KV_LOGICAL))


def _seq_parallel_qkv(params: dict, x: DTensor, positions: torch.Tensor,
                      cfg: ModelConfig, use_rope: bool):
    """:func:`qkv` in the sequence-parallel mode, as XLA partitions it:
    each rank projects its rows (its batch rows, its part of the
    sequence) into q, k and v; q keeps that placement (``Q_LOGICAL``) and
    k, v are gathered along the sequence (``KV_LOGICAL``), whose backward
    hands each rank its part's gradient. None where the sequence does not
    split over the mesh (a decode step) or a weight is not replicated:
    the caller then projects as without this mode."""
    from torch.distributed.tensor import Replicate, Shard
    xs = shard(x, "batch", "attn_seq", None)
    ws = [params[w] for w in ("wq", "wk", "wv")]
    if not any(isinstance(p, Shard) and p.dim == 1 for p in xs.placements) \
            or not all(isinstance(w, DTensor) and all(
                isinstance(p, Replicate) for p in w.placements) for w in ws):
        return None
    mesh, out = xs.device_mesh, xs.placements
    b, s, d = xs.shape
    shape, offset = local_shape_and_offset(xs)
    xl = shd.local(xs, out)
    pos = positions[offset[1]:offset[1] + shape[1]]
    parts = []
    for w in ws:
        wl = shd.local(w, out)
        t = (xl @ wl.reshape(d, -1)).view(*shape[:2], *wl.shape[1:])
        if use_rope and w is not ws[2]:
            t = rope(t, pos, cfg.rope_theta)
        parts.append(shd.from_local(t, (b, s) + tuple(w.shape[1:]), mesh,
                                    out))
    q, k, v = parts
    return (shard(q, *Q_LOGICAL), shard(k, *KV_LOGICAL),
            shard(v, *KV_LOGICAL))


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,d...->bs...")``: x ``[B, S, D]`` times w ``[D, *rest]``
    as one product against ``w`` viewed ``[D, prod(rest)]``. On ``DTensor``
    s each rank multiplies its rows of x (replicated over the mesh dims
    that split w's head dims) by its slice of w: no exchange, and no view
    that flattens a sharded dim."""
    b, s, d = x.shape
    if isinstance(w, DTensor):
        return shd.local_product(x, w, w.shape[1:], lambda xl, wl: (
            xl @ wl.reshape(d, -1)).view(xl.shape[0], s, *wl.shape[1:]))
    return (x @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


def _q_rows(qi: torch.Tensor) -> torch.Tensor:
    """q ``[b,q,h,g,d]`` as ``[b·h, g·q, d]`` rows for :func:`_scores`."""
    b, qc, h, g, d = qi.shape
    return qi.permute(0, 2, 3, 1, 4).reshape(b * h, g * qc, d)


def _scores(qm: torch.Tensor, kj: torch.Tensor, g: int) -> torch.Tensor:
    """``einsum("bqhgd,bkhd->bhgqk")`` in f32: q as :func:`_q_rows`, k
    ``[b,k,h,d]``."""
    b, ck, h, d = kj.shape
    km = kj.permute(0, 2, 3, 1).reshape(b * h, d, ck)
    return dot_f32(qm, km).view(b, h, g, -1, ck)


def _pv(p: torch.Tensor, vj: torch.Tensor) -> torch.Tensor:
    """``einsum("bhgqk,bkhd->bhgqd")`` in f32: p ``[b,h,g,q,k]``, v
    ``[b,k,h,d]``."""
    b, h, g, qc, ck = p.shape
    d = vj.shape[-1]
    vm = vj.permute(0, 2, 1, 3).reshape(b * h, ck, d)
    return dot_f32(p.reshape(b * h, g * qc, ck), vm).view(b, h, g, qc, d)


def chunked_causal_attention(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
        window: Optional[int] = None, causal: bool = True) -> torch.Tensor:
    """Causal (optionally local-window) or full attention, online softmax.

    q: ``[B, Sq, Hkv, G, hd]``; k, v: ``[B, Skv, Hkv, hd]``. Returns
    ``[B, Sq, Hkv, G, hd]``. ``causal=False`` gives bidirectional
    attention; Sq and Skv may differ. On ``DTensor`` inputs each rank runs
    the same blocks on its own shards (:func:`_local_blocks`).
    """
    b, s_in, hkv, g, hd = q.shape
    skv_in = k.shape[1]
    # Sequence-parallel attention: Q's sequence axis is model-sharded, so
    # one query block (sliced blocks would fragment the sharded dim);
    # causality is left to the mask (at most 2x the exact-causal score
    # FLOPs).
    qc = s_in if get_rule("attn_seq") is not None else min(
        cfg.attn_q_chunk, s_in)
    ck = min(cfg.attn_kv_chunk, skv_in)
    # Pad to chunk multiples. Padded keys sit at the END, so causality
    # keeps every real query off them (non-causal pads are masked);
    # padded query rows are sliced off before returning.
    s = ((s_in + qc - 1) // qc) * qc
    skv = ((skv_in + ck - 1) // ck) * ck
    if causal and s != skv:
        s = skv = max(s, skv)
    if s != s_in:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, s - s_in))
    if skv != skv_in:
        pad = (0, 0, 0, 0, 0, skv - skv_in)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    nq, nk = s // qc, skv // ck
    blocks = []                # (first query position, first/stop KV block)
    for i in range(nq):
        start = 0
        if causal and window is not None:
            # query p attends keys in (p - window, p]
            start = max(0, (i * qc - window + 1) // ck)
        stop = min(nk, -(-((i + 1) * qc) // ck)) if causal else nk
        blocks.append((i * qc, start, stop))
    if isinstance(q, DTensor):
        out = _local_blocks(q, k, v, blocks, qc, ck, causal, window, skv_in)
    else:
        out = _blocks(q, k, v, blocks, qc, ck, causal, window, skv_in)
    return shard(out[:, :s_in], *Q_LOGICAL)


def _blocks(q, k, v, blocks, rows: int, ck: int, causal: bool,
            window: Optional[int], skv_in: int, q0: int = 0):
    """The online-softmax loops: query block ``n`` is rows ``[n·rows,
    (n+1)·rows)`` of ``q``, at positions ``q0 + blocks[n][0]`` on, against
    KV blocks ``blocks[n][1] .. blocks[n][2] - 1``."""
    b, _, hkv, g, hd = q.shape
    dev = q.device
    scale = scalar_in(hd ** -0.5, q.dtype)
    ar_q = torch.arange(rows, device=dev)
    ar_k = torch.arange(ck, device=dev)

    out_blocks = []
    for n, (p0, start, stop) in enumerate(blocks):
        qi = q[:, n * rows:(n + 1) * rows] * scale
        qm = _q_rows(qi)
        q_pos = (q0 + p0) + ar_q
        m = torch.full((b, hkv, g, rows), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, rows), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, rows, hd), dtype=torch.float32,
                          device=dev)
        for j in range(start, stop):
            kj = k[:, j * ck:(j + 1) * ck]
            vj = v[:, j * ck:(j + 1) * ck]
            k_pos = j * ck + ar_k
            s_ij = _scores(qm, kj, g)
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
                if window is not None:
                    mask &= k_pos[None, :] > q_pos[:, None] - window
            else:
                mask = (k_pos < skv_in)[None, :].expand(rows, ck)
            # additive mask, as the reference adds it
            s_ij = s_ij + torch.where(mask, 0.0, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s_ij, dim=-1))
            p = torch.exp(s_ij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + _pv(p.to(qi.dtype), vj)
            m = m_new
        blk = (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
        out_blocks.append(blk.permute(0, 3, 1, 2, 4))   # → [b,q,h,g,d]
    return torch.cat(out_blocks, dim=1)


def _local_blocks(q, k, v, blocks, qc, ck, causal, window, skv_in):
    """:func:`_blocks` on each rank's shards of ``DTensor`` q, k, v placed
    by :data:`Q_LOGICAL` / :data:`KV_LOGICAL`: batch, KV heads and query
    groups split the work with no exchange; K/V keep the whole sequence.
    With the query sequence sharded (one block), the rank's rows are its
    slice of that block, at their global positions."""
    q = shard(q, *Q_LOGICAL)
    k, v = shard(k, *KV_LOGICAL), shard(v, *KV_LOGICAL)
    shape, offset = local_shape_and_offset(q)
    rows, q0 = qc, 0
    if shape[1] != q.shape[1]:
        (_, start, stop), = blocks
        blocks, rows, q0 = [(0, start, stop)], shape[1], offset[1]
    out = _blocks(*(shd.local(t, q.placements) for t in (q, k, v)), blocks,
                  rows, ck, causal, window, skv_in, q0)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=q.stride())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a (ring) KV cache.

    q: ``[B, 1, Hkv, G, hd]``; caches: ``[B, Smax, Hkv, hd]``; cache_len:
    ``[]`` int32 on the card (never read back). Returns ``[B, 1, Hkv, G,
    hd]``. On a ``DTensor`` cache, :func:`_local_decode`.
    """
    if isinstance(k_cache, DTensor):
        return _local_decode(q, k_cache, v_cache, cache_len)
    b, _, hkv, g, hd = q.shape
    smax = k_cache.shape[1]
    qg = q[:, 0] * scalar_in(hd ** -0.5, q.dtype)        # [b,h,g,d]
    s = _scores(_q_rows(qg[:, None]), k_cache, g)[:, :, :, 0]  # [b,h,g,S]
    valid = torch.arange(smax, device=q.device) < cache_len
    s = s + torch.where(valid, 0.0, NEG_INF)
    # jax.nn.softmax: exp(s - max) / sum
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    o = _pv(p[:, :, :, None].to(q.dtype), v_cache)[:, :, :, 0]
    return o[:, None].to(q.dtype)


def _local_decode(q, k_cache, v_cache, cache_len):
    """Decode attention on each rank's cache shard (flash-decode): q is
    placed like the cache's batch and head dims; where the cache's
    sequence is sharded, the softmax's max and sum and the ``P·V``
    products are all-reduced over those mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = k_cache.device_mesh
    want, seq_dims = [], []                     # cache [B, S, Hkv, hd]
    for d, pl in enumerate(k_cache.placements):
        if isinstance(pl, Shard) and pl.dim in (0, 2):   # = q's dims
            want.append(pl)
        else:
            want.append(Replicate())
            if isinstance(pl, Shard) and pl.dim == 1:
                seq_dims.append(d)
    q = q.redistribute(mesh, want)
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    b, _, hkv, g, hd = ql.shape
    smax = kl.shape[1]
    off = local_shape_and_offset(k_cache)[1][1]
    n = cache_len.to_local() if isinstance(cache_len, DTensor) else cache_len

    def reduce(t, op):
        return shd.all_reduce(t, op, mesh, seq_dims)
    qg = ql[:, 0] * scalar_in(hd ** -0.5, ql.dtype)
    s = _scores(_q_rows(qg[:, None]), kl, g)[:, :, :, 0]
    valid = (off + torch.arange(smax, device=ql.device)) < n
    s = s + torch.where(valid, 0.0, NEG_INF)
    e = torch.exp(s - reduce(torch.amax(s, dim=-1, keepdim=True), "max"))
    p = e / reduce(torch.sum(e, dim=-1, keepdim=True), "sum")
    o = reduce(_pv(p[:, :, :, None].to(ql.dtype), vl)[:, :, :, 0], "sum")
    return DTensor.from_local(o[:, None].to(ql.dtype), mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=q.stride())


def proj_out(params: dict, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out: ``[B, S, Hkv, G, hd]`` → ``[B, S, D]``."""
    b, s = attn_out.shape[:2]
    wo = params["wo"]
    if isinstance(wo, DTensor):
        out = _local_rows(attn_out, wo)
    else:
        out = attn_out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    return shard(out, "batch", None, "embed")


def _local_rows(attn_out, wo):
    """:func:`proj_out` on each rank's shards: its rows (batch, and the
    sequence in the sequence-parallel mode) of its heads times its heads'
    rows of ``wo``; where heads are sharded the result is a pending sum
    over those mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = wo.device_mesh
    want = shd.placements(shd.resolve_spec(Q_LOGICAL, attn_out.shape, mesh),
                          mesh)
    a = attn_out.redistribute(mesh, want)
    out = [pl if isinstance(pl, Shard) and pl.dim < 2
           else Partial() if isinstance(pl, Shard) else Replicate()
           for pl in a.placements]
    al, wl = shd.local(a, out), shd.local(wo, out)
    y = al.reshape(al.shape[0], al.shape[1], -1) @ wl.reshape(
        -1, wl.shape[-1])
    return shd.from_local(y, tuple(attn_out.shape[:2]) + (wo.shape[-1],),
                          mesh, out)
