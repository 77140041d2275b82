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
would change the softmax's order and its numbers). The reference's
sequence-parallel branch (``get_rule("attn_seq")``) is never taken on one
card: the query block is ``min(attn_q_chunk, S)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dot_f32, scalar_in
from repro_torch.models.param import ParamSpec

NEG_INF = -1e30


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
    b, s, d = x.shape
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    q = (x @ wq.reshape(d, -1)).view(b, s, *wq.shape[1:])
    k = (x @ wk.reshape(d, -1)).view(b, s, *wk.shape[1:])
    v = (x @ wv.reshape(d, -1)).view(b, s, *wv.shape[1:])
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


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
    attention; Sq and Skv may differ.
    """
    b, s_in, hkv, g, hd = q.shape
    skv_in = k.shape[1]
    dev = q.device
    qc = min(cfg.attn_q_chunk, s_in)
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
    scale = scalar_in(hd ** -0.5, q.dtype)
    ar_q = torch.arange(qc, device=dev)
    ar_k = torch.arange(ck, device=dev)

    out_blocks = []
    for i in range(nq):
        qi = q[:, i * qc:(i + 1) * qc] * scale
        qm = _q_rows(qi)
        q_pos = i * qc + ar_q
        start = 0
        if causal and window is not None:
            # query p attends keys in (p - window, p]
            start = max(0, (i * qc - window + 1) // ck)
        stop = min(nk, -(-((i + 1) * qc) // ck)) if causal else nk

        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, qc, hd), dtype=torch.float32,
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
                mask = (k_pos < skv_in)[None, :].expand(qc, ck)
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

    out = torch.cat(out_blocks, dim=1)
    return out[:, :s_in]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a (ring) KV cache.

    q: ``[B, 1, Hkv, G, hd]``; caches: ``[B, Smax, Hkv, hd]``; cache_len:
    ``[]`` int32 on the card (never read back). Returns ``[B, 1, Hkv, G,
    hd]``.
    """
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


def proj_out(params: dict, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out: ``[B, S, Hkv, G, hd]`` → ``[B, S, D]``."""
    b, s = attn_out.shape[:2]
    wo = params["wo"]
    return attn_out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
