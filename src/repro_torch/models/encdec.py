"""Encoder-decoder transformer (seamless-m4t-v2 backbone).

Counterpart of the reference's ``models/encdec.py``. The audio frontend
is a stub, as there: ``frames [B, F, d_model]`` are precomputed frame
embeddings fed straight into the encoder. Encoder layers are
bidirectional self-attention + MLP; decoder layers causal self-attention
+ cross-attention over the encoder's memory + MLP. The encoder's
self-attention and the cross-attention are the chunked online-softmax
attention with ``causal=False``; the cross-attention has no RoPE.

Per-layer params are stacked (``encoder`` and ``decoder``, a leading
``layers`` axis on every leaf, in the reference's tree order) and walked
with a Python loop, each layer recomputed in the backward when
``cfg.remat == "full"`` and a gradient is being taken, as
``models/transformer``'s. The serving state is a dict: the decoder's
self-attention cache ``self_k`` / ``self_v`` ``[L, B, S(max), Hkv, hd]``,
the cross-attention K/V of the memory ``cross_k`` / ``cross_v`` ``[L, B,
F, Hkv, hd]``, computed once per prompt, and ``position``. A decode step
writes its self-attention K/V in place at ``position`` clamped to
``S(max) - 1`` (XLA's clamp of ``dynamic_update_slice``), so a state
allocated with no room past the prompt rewrites its last slot, as the
reference's does. The reference's sharding annotations are kept (no-ops
without a mesh).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Skeletons
# ---------------------------------------------------------------------------

def _enc_layer_skeleton(cfg: ModelConfig) -> dict:
    return {
        "ln1": nn.rmsnorm_skeleton(cfg.d_model),
        "attn": attn.attention_skeleton(cfg),
        "ln2": nn.rmsnorm_skeleton(cfg.d_model),
        "mlp": nn.mlp_skeleton(cfg),
    }


def _dec_layer_skeleton(cfg: ModelConfig) -> dict:
    return {
        "ln1": nn.rmsnorm_skeleton(cfg.d_model),
        "self_attn": attn.attention_skeleton(cfg),
        "ln_x": nn.rmsnorm_skeleton(cfg.d_model),
        "cross_attn": attn.attention_skeleton(cfg),
        "ln2": nn.rmsnorm_skeleton(cfg.d_model),
        "mlp": nn.mlp_skeleton(cfg),
    }


def encdec_skeleton(cfg: ModelConfig) -> dict:
    return {
        "encoder": tr._stack(_enc_layer_skeleton(cfg),
                             cfg.num_encoder_layers or cfg.num_layers),
        "enc_final_ln": nn.rmsnorm_skeleton(cfg.d_model),
        "embed": nn.embedding_skeleton(cfg),
        "decoder": tr._stack(_dec_layer_skeleton(cfg), cfg.num_layers),
        "final_ln": nn.rmsnorm_skeleton(cfg.d_model),
        "unembed": nn.unembed_skeleton(cfg),
    }


def _layers(stack: dict) -> list:
    return tr._layers(stack, stack["ln1"]["scale"].shape[0])


def _walk(layer, stack: dict, x: torch.Tensor, cfg: ModelConfig,
          *args) -> torch.Tensor:
    """``x`` through ``layer(lp, x, *args, cfg)`` for each layer of
    ``stack``; with ``remat == "full"`` under a gradient, each layer
    recomputed in the backward."""
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for lp in _layers(stack):
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, lp, x, *args, cfg,
                                                  use_reentrant=False)
        else:
            x = layer(lp, x, *args, cfg)
    return x


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _enc_layer(lp: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(lp["attn"], h, positions, cfg)
    o = attn.chunked_causal_attention(q, k, v, cfg, causal=False)
    x = x + attn.proj_out(lp["attn"], o)
    h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return shard(x + nn.mlp(lp["mlp"], h, cfg), "batch", None, "embed")


def encode(params: dict, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames ``[B, F, d_model]`` (the frontend stub's output) → memory
    ``[B, F, D]``."""
    x = shard(frames.to(cfg.dtype), "batch", None, "embed")
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = _walk(_enc_layer, params["encoder"], x, cfg, positions)
    return nn.rmsnorm(params["enc_final_ln"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_q(p: dict, h: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhgk->bshgk", h, wq)``: the queries, no RoPE."""
    return attn.project(h, p["wq"])


def _cross_kv(p: dict, memory: torch.Tensor) -> tuple:
    """``einsum("bfd,dhk->bfhk", memory, wk / wv)``: the memory's keys
    and values, no RoPE."""
    return tuple(attn.project(memory, p[w]) for w in ("wk", "wv"))


def _dec_layer_prefill(lp: dict, x: torch.Tensor, memory: torch.Tensor,
                       positions: torch.Tensor, cfg: ModelConfig):
    """One decoder layer over the whole target; returns its output, its
    self-attention K/V and its cross-attention K/V."""
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(lp["self_attn"], h, positions, cfg)
    o = attn.chunked_causal_attention(q, k, v, cfg)
    x = x + attn.proj_out(lp["self_attn"], o)
    h = nn.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
    qx = _cross_q(lp["cross_attn"], h)
    km, vm = _cross_kv(lp["cross_attn"], memory)
    ox = attn.chunked_causal_attention(qx, km, vm, cfg, causal=False)
    x = x + attn.proj_out(lp["cross_attn"], ox)
    h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    x = shard(x + nn.mlp(lp["mlp"], h, cfg), "batch", None, "embed")
    return x, k, v, km, vm


def _dec_layer(lp: dict, x: torch.Tensor, memory: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = _dec_layer_prefill(lp, x, memory, positions, cfg)[0]
    return shard(x, "batch", None, "embed")


def encdec_loss(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig,
                seq_weights: Optional[torch.Tensor] = None):
    """Teacher-forced seq2seq loss (frames → target token stream): the
    whole sequences in, the targets rolled by one with the last position
    masked, the f32 logits of every position at once, weighted as
    ``transformer.lm_loss``."""
    memory = encode(params, frames, cfg)
    targets = nn.next_tokens(tokens)
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    x = nn.embed(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = _walk(_dec_layer, params["decoder"], x, cfg, memory, positions)
    h = nn.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    logits = nn.unembed(params["unembed"], h)
    lse, picked = nn.xent_parts(logits, targets)
    per_seq = torch.sum((lse - picked) * mask, dim=1) / torch.clamp(
        torch.sum(mask, dim=1), min=1.0)
    w = (seq_weights if seq_weights is not None else torch.ones(
        per_seq.shape, dtype=torch.float32, device=tokens.device)).to(
        torch.float32)
    loss = torch.sum(w * per_seq) / torch.clamp(torch.sum(w), min=1e-9)
    return loss, {"loss": loss}


def encdec_prefill(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
                   cfg: ModelConfig, max_len: int = 0):
    """Encode, then the teacher-forced decoder over the prompt → the last
    token's f32 logits ``[B, 1, vocab]`` and the serving state (module
    docstring). ``max_len``: the self-attention cache's slots (0, or
    anything shorter than the prompt, allocates exactly the prompt)."""
    memory = encode(params, frames, cfg)
    x = nn.embed(params["embed"], tokens).to(cfg.dtype)
    b, s = x.shape[:2]
    f = memory.shape[1]
    dev = x.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    layers = _layers(params["decoder"])
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    alloc = max(max_len, s)
    shapes = {"self": (len(layers), b, alloc, hkv, hd),
              "cross": (len(layers), b, f, hkv, hd)}
    state = {f"{n}_{t}": shd.zeros(shapes[n], kvc.CACHE_LOGICAL, cfg.dtype,
                                   dev)
             for n in ("self", "cross") for t in ("k", "v")}
    for i, lp in enumerate(layers):
        x, k, v, km, vm = _dec_layer_prefill(lp, x, memory, positions, cfg)
        kvc.write_prompt(state["self_k"], state["self_v"], i, k, v, s)
        kvc.write_prompt(state["cross_k"], state["cross_v"], i, km, vm, f)
    h = nn.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    logits = nn.unembed(params["unembed"], h[:, -1:])
    state["position"] = torch.full((), s, dtype=torch.int32, device=dev)
    return logits, state


def encdec_decode_step(params: dict, state: dict, tokens: torch.Tensor,
                       cfg: ModelConfig):
    """One decode step for the whole batch: tokens ``[B, 1]`` → f32
    logits ``[B, 1, vocab]`` and the state one token on. The
    self-attention K/V are written in place (the returned state shares
    every tensor with ``state`` but ``position``); the cross-attention
    reads all ``F`` frames of ``cross_k`` / ``cross_v``. Nothing is read
    back to the host."""
    x = nn.embed(params["embed"], tokens).to(cfg.dtype)
    pos = state["position"]
    posv = pos.reshape(1)
    self_k, self_v = state["self_k"], state["self_v"]
    slot = torch.clamp(posv.long(), 0, self_k.shape[2] - 1)
    valid = pos + 1
    frames = state["cross_k"].shape[2]
    for i, lp in enumerate(_layers(params["decoder"])):
        sk, sv = self_k[i], self_v[i]
        h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = attn.qkv(lp["self_attn"], h, posv, cfg)
        kvc.write_at(sk, sv, slot, k, v)
        o = attn.decode_attention(q, sk, sv, valid)
        x = x + attn.proj_out(lp["self_attn"], o)
        h = nn.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
        qx = _cross_q(lp["cross_attn"], h)
        ox = attn.decode_attention(qx, state["cross_k"][i],
                                   state["cross_v"][i], frames)
        x = x + attn.proj_out(lp["cross_attn"], ox)
        h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = shard(x + nn.mlp(lp["mlp"], h, cfg), "batch", None, "embed")
    h = nn.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    logits = nn.unembed(params["unembed"], h)
    return logits, dict(state, position=pos + 1)


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device: torch.device) -> dict:
    """The zero state at position ``cache_len``: ``cache_len + 16``
    self-attention slots and ``cfg.num_frames`` (or ``cache_len``)
    frames of cross-attention K/V, as the reference's
    ``api.init_decode_state``."""
    hkv, hd, n = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    frames = cfg.num_frames or cache_len

    def zeros(slots):
        return torch.zeros((n, batch, slots, hkv, hd), dtype=cfg.dtype,
                           device=device)
    return {"self_k": zeros(cache_len + 16), "self_v": zeros(cache_len + 16),
            "cross_k": zeros(frames), "cross_v": zeros(frames),
            "position": torch.full((), cache_len, dtype=torch.int32,
                                   device=device)}
