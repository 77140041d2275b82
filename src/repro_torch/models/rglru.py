"""RecurrentGemma / Griffin-style hybrid: RG-LRU blocks + local attention.

Counterpart of the reference's ``models/rglru.py``. The block pattern
cycles ``(rec, rec, attn)``. The RG-LRU linear recurrence ``h_t = a_t ·
h_{t-1} + b_t`` trains and prefills with a log-depth doubling scan in f32
(:func:`linear_scan`, 11 levels at 2,048 tokens; the reference's
``jax.lax.associative_scan`` combines in another tree order, so the two
agree to rounding, not bit for bit) and decodes with an O(1) carried
state. The attention blocks attend within ``local_window`` keys and
decode against a ring of that many slots: position ``p`` lives at slot
``p % window``, written on the device through a tensor index (no read
of the position back to the host). The reference's sharding annotations
are kept (no-ops without a mesh).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as nn
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec
from repro_torch.utils import DeviceLike, resolve_device

_RG_C = 8.0   # Griffin's fixed recurrence sharpness constant


def block_kind(cfg: ModelConfig, i: int) -> str:
    pattern = cfg.block_pattern or ("rec", "rec", "attn")
    return pattern[i % len(pattern)]


# ---------------------------------------------------------------------------
# Skeletons
# ---------------------------------------------------------------------------

def _rec_block_skeleton(cfg: ModelConfig) -> dict:
    d, r = cfg.d_model, cfg.rnn_width or cfg.d_model
    return {
        "ln1": nn.rmsnorm_skeleton(d),
        "w_gelu": ParamSpec((d, r), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "w_rec": ParamSpec((d, r), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "conv_w": ParamSpec((cfg.conv_width, r), (None, "rnn"),
                            dtype=cfg.dtype, init="normal", scale=0.1),
        "conv_b": ParamSpec((r,), ("rnn",), init="zeros", dtype=cfg.dtype),
        "gate_a": ParamSpec((r, r), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "gate_a_b": ParamSpec((r,), ("rnn",), init="zeros", dtype=cfg.dtype),
        "gate_x": ParamSpec((r, r), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "gate_x_b": ParamSpec((r,), ("rnn",), init="zeros", dtype=cfg.dtype),
        "lam": ParamSpec((r,), ("rnn",), init="ones", dtype=torch.float32,
                         scale=1.0),
        "w_out": ParamSpec((r, d), ("rnn", "embed_tp"), dtype=cfg.dtype),
        "ln2": nn.rmsnorm_skeleton(d),
        "mlp": nn.mlp_skeleton(cfg),
    }


def _attn_block_skeleton(cfg: ModelConfig) -> dict:
    return {
        "ln1": nn.rmsnorm_skeleton(cfg.d_model),
        "attn": attn.attention_skeleton(cfg),
        "ln2": nn.rmsnorm_skeleton(cfg.d_model),
        "mlp": nn.mlp_skeleton(cfg),
    }


def rg_skeleton(cfg: ModelConfig) -> dict:
    blocks = [(_rec_block_skeleton(cfg) if block_kind(cfg, i) == "rec"
               else _attn_block_skeleton(cfg))
              for i in range(cfg.num_layers)]
    return {
        "embed": nn.embedding_skeleton(cfg),
        "blocks": blocks,
        "final_ln": nn.rmsnorm_skeleton(cfg.d_model),
        "unembed": nn.unembed_skeleton(cfg),
    }


# ---------------------------------------------------------------------------
# RG-LRU cell
# ---------------------------------------------------------------------------

def _rg_gates(bp: dict, x: torch.Tensor):
    """x: ``[..., R]`` → (log_a, b) of the linear recurrence h = a·h + b,
    f32. The gate products and their biases are summed in x's dtype, then
    widened, as the reference's."""
    r_gate = torch.sigmoid((x @ bp["gate_a"] + bp["gate_a_b"]).float())
    i_gate = torch.sigmoid((x @ bp["gate_x"] + bp["gate_x_b"]).float())
    log_a = -_RG_C * nn.softplus(bp["lam"]) * r_gate
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * i_gate * x.float()
    return log_a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t · h_{t-1} + b_t`` along dim 1 from ``h_{-1} = 0``: a
    doubling (Hillis–Steele) scan of the combine ``(a1, b1), (a2, b2) →
    (a1·a2, a2·b1 + b2)``, ``ceil(log2 S)`` levels of whole-tensor
    products. No cumulative sum or product of logs (the products
    underflow), no loop over time."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(bp: dict, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> tuple:
    """Training / prefill RG-LRU over ``[B, S, R]``: (h in x's dtype, the
    last f32 state ``[B, R]``)."""
    log_a, b = _rg_gates(bp, x)
    a = torch.exp(log_a)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    if isinstance(a, shd.DTensor):
        h = _local_scan(a, b)
    else:
        h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def _local_scan(a, b):
    """:func:`linear_scan` on each rank's shards (batch rows and recurrent
    channels are independent): a and b placed ``("batch", None, "rnn")``,
    the whole sequence on every rank."""
    a, b = (shard(t, "batch", None, "rnn") for t in (a, b))
    with shd.local_region():
        h = linear_scan(shd.local(a, b.placements),
                        shd.local(b, b.placements))
    return shd.from_local(h, tuple(b.shape), b.device_mesh, b.placements)


def rglru_step(bp: dict, x: torch.Tensor, h: torch.Tensor) -> tuple:
    """Decode-mode single step. x: ``[B, R]``, h: ``[B, R]`` (f32)."""
    log_a, b = _rg_gates(bp, x)
    h_new = torch.exp(log_a) * h + b
    return h_new.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _rec_block_fwd(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[dict] = None, decode: bool = False):
    y = nn.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    # jax.nn.gelu's default is the tanh approximation.
    lhs = F.gelu((y @ bp["w_gelu"]).float(), approximate="tanh").to(x.dtype)
    rhs = shard(y @ bp["w_rec"], "batch", None, "rnn")
    if decode:
        conv, new_tail = nn.causal_conv(bp["conv_w"], bp["conv_b"], rhs,
                                         state["conv"])
        out, new_h = rglru_step(bp, conv[:, 0], state["h"])
        out = out[:, None]
        new_state = {"h": new_h, "conv": new_tail}
    else:
        conv, tail = nn.causal_conv(bp["conv_w"], bp["conv_b"], rhs)
        out, h_last = rglru_scan(bp, conv)
        new_state = {"h": h_last, "conv": tail}
    merged = (lhs.float() * out.float()).to(x.dtype)
    # the out-projection's pending sum resolved onto the residual's layout
    x = x + shard(merged @ bp["w_out"], "batch", None, "embed")
    h2 = nn.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return shard(x + nn.mlp(bp["mlp"], h2, cfg), "batch", None,
                 "embed"), new_state


def ring_tail(kv: torch.Tensor, window: int) -> torch.Tensor:
    """A prefill's last ``window`` K or V ``[B, S, Hkv, hd]`` as a ring of
    ``window`` slots: zero-padded at the end while ``S < window``, else
    rolled so that position ``p`` sits at slot ``p % window``. On a
    ``DTensor`` each rank its own rows and heads (the sequence is whole on
    every rank; torch 2.11's ``DTensor`` has no strategy for ``roll`` and
    fails to plan this ``pad``)."""
    if isinstance(kv, shd.DTensor):
        kv = shard(kv, *attn.KV_LOGICAL)
        pl = kv.placements
        with shd.local_region():
            tail = ring_tail(shd.local(kv, pl), window)
        return shd.from_local(tail, (kv.shape[0], window) + tuple(
            kv.shape[2:]), kv.device_mesh, pl)
    s = kv.shape[1]
    tail = F.pad(kv[:, -window:], (0, 0, 0, 0, 0, max(window - s, 0)))
    if s >= window:
        tail = torch.roll(tail, s % window, dims=1)
    return tail


def _attn_block_fwd(bp: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, state: Optional[dict] = None,
                    decode: bool = False,
                    pos: Optional[torch.Tensor] = None):
    h = nn.rmsnorm(bp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(bp["attn"], h, positions, cfg)
    w = cfg.local_window
    if decode:
        # The ring's slot pos % w, written in place on the device.
        slot = torch.remainder(pos.reshape(1).long(), w)
        lk, lv = state["k"], state["v"]
        kvc.write_at(lk, lv, slot, k, v)
        o = attn.decode_attention(q, lk, lv, torch.clamp(pos + 1, max=w))
        new_state = {"k": lk, "v": lv}
    else:
        o = attn.chunked_causal_attention(q, k, v, cfg, window=w)
        new_state = {"k": ring_tail(k, w), "v": ring_tail(v, w)}
    x = x + attn.proj_out(bp["attn"], o)
    h2 = nn.rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return shard(x + nn.mlp(bp["mlp"], h2, cfg), "batch", None,
                 "embed"), new_state


# ---------------------------------------------------------------------------
# Model: loss / prefill / decode
# ---------------------------------------------------------------------------

def _forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
             states: Optional[list] = None, decode: bool = False,
             pos: Optional[torch.Tensor] = None):
    x = nn.embed(params["embed"], tokens).to(cfg.dtype)
    if decode:
        positions = pos.reshape(1)
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    remat = cfg.remat == "full" and not decode and torch.is_grad_enabled()
    new_states = []
    for i, bp in enumerate(params["blocks"]):
        st = states[i] if states is not None else None
        if block_kind(cfg, i) == "rec":
            fn, args = _rec_block_fwd, (bp, x, cfg, st, decode)
        else:
            fn, args = _attn_block_fwd, (bp, x, positions, cfg, st, decode,
                                         pos)
        if remat:
            x, ns = torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False)
        else:
            x, ns = fn(*args)
        new_states.append(ns)
    return nn.rmsnorm(params["final_ln"], x, cfg.norm_eps), new_states


def rg_loss(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            seq_weights: Optional[torch.Tensor] = None):
    """Weighted causal-LM loss (``layers.weighted_lm_loss``)."""
    h, _ = _forward(params, tokens, cfg)
    loss = nn.weighted_lm_loss(params["unembed"], h, tokens, seq_weights)
    return loss, {"loss": loss}


def rg_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The prompt's last f32 logits ``[B, 1, vocab]`` and the decode
    state: each recurrent block's state and conv tail, each attention
    block's K/V ring, and the position."""
    h, states = _forward(params, tokens, cfg)
    logits = nn.unembed(params["unembed"], h[:, -1:])
    return logits, {"blocks": states, "position": torch.full(
        (), tokens.shape[1], dtype=torch.int32, device=tokens.device)}


def rg_decode_step(params: dict, state: dict, tokens: torch.Tensor,
                   cfg: ModelConfig):
    """One decode step: tokens ``[B, 1]`` → f32 logits. The attention
    rings are written in place (the returned state shares them)."""
    pos = state["position"]
    h, new_states = _forward(params, tokens, cfg, states=state["blocks"],
                             decode=True, pos=pos)
    logits = nn.unembed(params["unembed"], h)
    return logits, {"blocks": new_states, "position": pos + 1}


def rg_init_decode_state(cfg: ModelConfig, batch: int,
                         device: DeviceLike = None) -> dict:
    """Zero decode state: a saturated O(1) state for a recurrent arch."""
    dev = resolve_device(device)
    r = cfg.rnn_width or cfg.d_model
    ring = (batch, cfg.local_window, cfg.num_kv_heads, cfg.head_dim)
    states = []
    for i in range(cfg.num_layers):
        if block_kind(cfg, i) == "rec":
            states.append({
                "h": torch.zeros(batch, r, dtype=torch.float32, device=dev),
                "conv": torch.zeros(batch, cfg.conv_width - 1, r,
                                    dtype=cfg.dtype, device=dev),
            })
        else:
            states.append({
                "k": torch.zeros(ring, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(ring, dtype=cfg.dtype, device=dev),
            })
    return {"blocks": states, "position": torch.zeros(
        (), dtype=torch.int32, device=dev)}
