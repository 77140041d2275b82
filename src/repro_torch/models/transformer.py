"""Decoder-only transformer LM (dense + MoE): train, prefill, decode.

Counterpart of the reference's ``models/transformer.py``. Per-layer
params are stacked (a leading ``layers`` axis on every leaf, the
reference's layout) and walked with a Python loop over the layers where
the reference scans; ``scan_layers`` has no meaning without a compiler.
MoE configs carry two stacks, ``dense_layers`` (the ``first_dense_layers``
leading ones, if any) and ``moe_layers`` (``models/moe.moe_ffn`` in place
of the MLP), walked in that order. The per-layer views come from one
``torch.unbind`` per leaf and forward, so a backward stacks each leaf's
gradient once. ``remat == "full"`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
its scan body. Serving runs under ``torch.inference_mode()``.
``extra_embeds`` (the vlm family's patch embeddings, ``models/vlm``) are
prepended to the token embeddings, the positions running over both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec, map_tree


#: The stacks of a params tree, in the order they run, and whether each
#: holds MoE layers.
STACKS = (("dense_layers", False), ("moe_layers", True))


# ---------------------------------------------------------------------------
# Skeletons
# ---------------------------------------------------------------------------

def _layer_skeleton(cfg: ModelConfig, use_moe: bool) -> dict:
    skel = {
        "ln1": nn.rmsnorm_skeleton(cfg.d_model),
        "attn": attn.attention_skeleton(cfg),
        "ln2": nn.rmsnorm_skeleton(cfg.d_model),
    }
    if use_moe:
        skel["moe"] = moe_lib.moe_skeleton(cfg)
    else:
        d_ff = cfg.d_ff or cfg.expert_d_ff * max(
            cfg.num_experts_per_token + cfg.num_shared_experts, 1)
        skel["mlp"] = nn.mlp_skeleton(cfg, d_ff)
    return skel


def _stack(skel: dict, n: int) -> dict:
    return map_tree(lambda _p, s: ParamSpec(
        (n,) + s.shape, ("layers",) + s.logical, dtype=s.dtype,
        init=s.init, scale=s.scale), skel)


def lm_skeleton(cfg: ModelConfig) -> dict:
    n_dense = cfg.first_dense_layers if cfg.is_moe else cfg.num_layers
    n_moe = cfg.num_layers - cfg.first_dense_layers if cfg.is_moe else 0
    skel = {
        "embed": nn.embedding_skeleton(cfg),
        "final_ln": nn.rmsnorm_skeleton(cfg.d_model),
        "unembed": nn.unembed_skeleton(cfg),
    }
    if n_dense:
        skel["dense_layers"] = _stack(_layer_skeleton(cfg, False), n_dense)
    if n_moe:
        skel["moe_layers"] = _stack(_layer_skeleton(cfg, True), n_moe)
    return skel


def _layers(stack: dict, n: int) -> list:
    """Every layer's params, from one ``unbind`` per stacked leaf."""
    views = map_tree(lambda _p, t: t.unbind(0), stack)
    return [map_tree(lambda _p, t: t[i], views) for i in range(n)]


def _stacks(params: dict) -> list:
    """``(per-layer params, use_moe)`` of every layer, in order."""
    out = []
    for name, use_moe in STACKS:
        if name in params:
            stack = params[name]
            n = stack["ln1"]["scale"].shape[0]
            out += [(lp, use_moe) for lp in _layers(stack, n)]
    return out


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------

def _ffn(lp: dict, h: torch.Tensor, cfg: ModelConfig,
         use_moe: bool) -> torch.Tensor:
    if use_moe:
        return moe_lib.moe_ffn(lp["moe"], h, cfg)
    return nn.mlp(lp["mlp"], h, cfg)


def _layer_prefill(lp: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, use_moe: bool,
                   window: Optional[int] = None):
    """Forward one layer and return its K/V for the cache."""
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(lp["attn"], h, positions, cfg)
    o = attn.chunked_causal_attention(q, k, v, cfg, window=window)
    x = x + attn.proj_out(lp["attn"], o)
    h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + _ffn(lp, h, cfg, use_moe), k, v


def _layer_fwd(lp: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, use_moe: bool) -> torch.Tensor:
    return _layer_prefill(lp, x, positions, cfg, use_moe)[0]


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           extra_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings ``[B, S, D]``, after ``extra_embeds`` ``[B, P,
    D]`` when given."""
    x = nn.embed(params["embed"], tokens).to(cfg.dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cfg.dtype), x], dim=1)
    return x


def hidden_states(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  extra_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Token (after optional prepended modality) embeddings → final
    hidden states ``[B, P + S, D]``; differentiable, each layer
    recomputed in the backward when ``cfg.remat == "full"`` and a
    gradient is being taken."""
    x = _embed(params, tokens, cfg, extra_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for lp, use_moe in _stacks(params):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer_fwd, lp, x, positions, cfg, use_moe,
                use_reentrant=False)
        else:
            x = _layer_fwd(lp, x, positions, cfg, use_moe)
    return nn.rmsnorm(params["final_ln"], x, cfg.norm_eps)


def _xent_from_hidden(params: dict, h: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-position cross entropy ``[B, S]`` (f32), masked; with
    ``cfg.logit_chunk`` dividing S (and below it) the sequence is taken
    ``logit_chunk`` positions at a time, so the whole ``[B, S, vocab]``
    logits never exist at once."""
    def chunk_nll(h_c, t_c):
        logits = nn.unembed(params["unembed"], h_c)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, t_c[..., None].long())[..., 0]
        return lse - picked

    s = h.shape[1]
    ck = cfg.logit_chunk
    if not ck or s <= ck or s % ck:
        nll = chunk_nll(h, targets)
    else:
        nll = torch.cat([chunk_nll(h[:, i:i + ck], targets[:, i:i + ck])
                         for i in range(0, s, ck)], dim=1)
    return nll * mask


def lm_loss(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            seq_weights: Optional[torch.Tensor] = None,
            extra_embeds: Optional[torch.Tensor] = None):
    """Weighted causal-LM loss ``Σ_b w_b ℓ̄_b / Σ_b w_b`` and its metrics.

    ``seq_weights``: OASRS stratum weights ``W_i`` per sequence, the
    Horvitz–Thompson estimator of the full-stream loss. The inputs are
    the whole sequences and the targets the sequences rolled by one, the
    last position masked, as the reference's. With ``extra_embeds`` the
    hidden states of their positions are cut off: the loss covers the
    text only.
    """
    b = tokens.shape[0]
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    h = hidden_states(params, tokens, cfg, extra_embeds)
    if extra_embeds is not None:
        h = h[:, extra_embeds.shape[1]:]
    nll = _xent_from_hidden(params, h, targets, mask, cfg)
    per_seq = torch.sum(nll, dim=1) / torch.clamp(torch.sum(mask, dim=1),
                                                  min=1.0)
    if seq_weights is None:
        seq_weights = torch.ones(b, dtype=torch.float32,
                                 device=tokens.device)
    w = seq_weights.to(torch.float32)
    loss = torch.sum(w * per_seq) / torch.clamp(torch.sum(w), min=1e-9)
    return loss, {"loss": loss, "tokens": torch.sum(mask)}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            window: int = 0, max_len: int = 0,
            extra_embeds: Optional[torch.Tensor] = None):
    """Run the whole prompt, build the KV cache, return the last token's
    f32 logits ``[B, 1, vocab]`` and the cache.

    ``max_len``: cache allocation (prompt length + decode budget); 0 (and
    anything shorter than the prompt) allocates exactly the prompt. The
    cache is allocated once and each layer's K/V written into it. With
    ``extra_embeds`` the prompt is they and the tokens: the cache holds
    and the position counts both.
    """
    x = _embed(params, tokens, cfg, extra_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    layers = _stacks(params)
    kept = min(s, window) if window else s
    alloc = kept if window else max(max_len, s)
    cache = kvc.init_cache(cfg, len(layers), b, alloc, window=window,
                           device=x.device)
    for i, (lp, use_moe) in enumerate(layers):
        x, k, v = _layer_prefill(lp, x, positions, cfg, use_moe,
                                 window=window or None)
        cache.k[i, :, :kept] = k[:, s - kept:]
        cache.v[i, :, :kept] = v[:, s - kept:]
    h = nn.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    logits = nn.unembed(params["unembed"], h[:, -1:])
    cache.position.fill_(kept)
    return logits, cache


def _layer_decode(lp: dict, x: torch.Tensor, layer_k: torch.Tensor,
                  layer_v: torch.Tensor, cache: kvc.KVCache,
                  cfg: ModelConfig, use_moe: bool):
    pos = cache.position.reshape(1)
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(lp["attn"], h, pos, cfg)
    kvc.write_token(layer_k, layer_v, cache, k, v)
    valid = kvc.cache_len(cache) + 1
    o = attn.decode_attention(q, layer_k, layer_v, valid)
    x = x + attn.proj_out(lp["attn"], o)
    h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + _ffn(lp, h, cfg, use_moe)


def decode_step(params: dict, cache: kvc.KVCache, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decode step for the whole batch: tokens ``[B, 1]`` → f32
    logits ``[B, 1, vocab]`` and the cache one token on.

    The cache's K/V tensors are written in place (the returned cache
    shares them with ``cache``); only ``position`` is a new tensor.
    Nothing is read back to the host.
    """
    x = nn.embed(params["embed"], tokens).to(cfg.dtype)
    for i, (lp, use_moe) in enumerate(_stacks(params)):
        x = _layer_decode(lp, x, cache.k[i], cache.v[i], cache, cfg,
                          use_moe)
    h = nn.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    logits = nn.unembed(params["unembed"], h)
    return logits, dataclasses.replace(cache, position=cache.position + 1)
