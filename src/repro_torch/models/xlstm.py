"""xLSTM: alternating mLSTM (matrix-memory) and sLSTM (scalar-memory) blocks.

Counterpart of the reference's ``models/xlstm.py``: the xLSTM paper's
cells with exponential gating and the max-stabilizer ``m_t``. Both cells
are linear-state recurrences, so the decode state per block is O(1).

Time is walked with a Python loop over the steps where the reference
scans (``time_unroll`` has no meaning without a compiler, as
``scan_layers`` has none in the dense port). ``remat == "full"``
recomputes each block in the backward (``torch.utils.checkpoint``), as
the reference's ``jax.checkpoint`` per block: at xlstm-350m's width an
mLSTM state ``C`` is ``[8, 4, 512, 512]`` f32, 33.5 MB per time step,
and without recomputation every block's steps would stay alive for the
backward. ``d_ff=0``: blocks carry their own up/down projections, there
is no separate FFN. The reference's sharding annotations are kept
(no-ops without a mesh); under a mesh the cells' time loops and the
group norm run shard-local on each rank's batch rows.

Dtypes follow the reference's promotion: ``cpath @ w_if`` multiplies a
bf16 activation by an f32 weight, which JAX computes in f32; ``cpath @
w_i + b_i`` rounds the bf16 product first and adds the f32 bias in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard
from repro_torch.models import layers as nn
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec
from repro_torch.utils import DeviceLike, resolve_device


def block_kind(cfg: ModelConfig, i: int) -> str:
    pattern = cfg.block_pattern or ("mlstm", "slstm")
    return pattern[i % len(pattern)]


# ---------------------------------------------------------------------------
# Skeletons
# ---------------------------------------------------------------------------

def _mlstm_skeleton(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    di = 2 * d                       # pre-up-projection factor 2 (paper)
    return {
        "ln": nn.rmsnorm_skeleton(d),
        "w_up": ParamSpec((d, di), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "w_z": ParamSpec((d, di), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "conv_w": ParamSpec((cfg.conv_width, di), (None, "rnn"),
                            dtype=cfg.dtype, init="normal", scale=0.1),
        "conv_b": ParamSpec((di,), ("rnn",), init="zeros", dtype=cfg.dtype),
        "wq": ParamSpec((di, di), ("rnn", None), dtype=cfg.dtype),
        "wk": ParamSpec((di, di), ("rnn", None), dtype=cfg.dtype),
        "wv": ParamSpec((di, di), ("rnn", None), dtype=cfg.dtype),
        "w_if": ParamSpec((di, 2 * h), ("rnn", None), dtype=torch.float32),
        "b_if": ParamSpec((2 * h,), (None,), init="zeros",
                          dtype=torch.float32),
        "gn": ParamSpec((di,), ("rnn",), init="ones", dtype=torch.float32),
        "w_down": ParamSpec((di, d), ("rnn", "embed_tp"), dtype=cfg.dtype),
    }


def _slstm_skeleton(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln": nn.rmsnorm_skeleton(d),
        "conv_w": ParamSpec((cfg.conv_width, d), (None, "rnn"),
                            dtype=cfg.dtype, init="normal", scale=0.1),
        "conv_b": ParamSpec((d,), ("rnn",), init="zeros", dtype=cfg.dtype),
        "w_i": ParamSpec((d, d), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "w_f": ParamSpec((d, d), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "w_z": ParamSpec((d, d), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "w_o": ParamSpec((d, d), ("embed_tp", "rnn"), dtype=cfg.dtype),
        "b_i": ParamSpec((d,), ("rnn",), init="zeros", dtype=torch.float32),
        "b_f": ParamSpec((d,), ("rnn",), init="ones", dtype=torch.float32),
        "b_z": ParamSpec((d,), ("rnn",), init="zeros", dtype=torch.float32),
        "b_o": ParamSpec((d,), ("rnn",), init="zeros", dtype=torch.float32),
        "gn": ParamSpec((d,), ("rnn",), init="ones", dtype=torch.float32),
        "w_down": ParamSpec((d, d), ("rnn", "embed_tp"), dtype=cfg.dtype),
    }


def xlstm_skeleton(cfg: ModelConfig) -> dict:
    blocks = [(_mlstm_skeleton(cfg) if block_kind(cfg, i) == "mlstm"
               else _slstm_skeleton(cfg)) for i in range(cfg.num_layers)]
    return {
        "embed": nn.embedding_skeleton(cfg),
        "blocks": blocks,
        "final_ln": nn.rmsnorm_skeleton(cfg.d_model),
        "unembed": nn.unembed_skeleton(cfg),
    }


# ---------------------------------------------------------------------------
# Cells (single step), shared by training and decode.
# ---------------------------------------------------------------------------

def _mlstm_cell(q, k, v, i_til, f_til, state):
    """One mLSTM step. q/k/v: ``[B, H, hd]``; i/f: ``[B, H]``; state:
    (C, n, m), all f32."""
    c_prev, n_prev, m_prev = state
    k = k / math.sqrt(q.shape[-1])
    fm = f_til + m_prev
    m_new = torch.maximum(fm, i_til)
    i_p = torch.exp(i_til - m_new)
    f_p = torch.exp(fm - m_new)
    c_new = f_p[..., None, None] * c_prev + \
        i_p[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f_p[..., None] * n_prev + i_p[..., None] * k
    num = torch.matmul(c_new, q[..., None])[..., 0]          # bhvk,bhk->bhv
    den = torch.clamp(torch.abs(torch.sum(n_new * q, dim=-1)), min=1.0)
    return num / den[..., None], (c_new, n_new, m_new)


def _slstm_cell(i_til, f_til, z, o, state):
    """One sLSTM step. gates: ``[B, D (= H·hd)]``; state: (c, n, m)."""
    c_prev, n_prev, m_prev = state
    fm = f_til + m_prev
    m_new = torch.maximum(fm, i_til)
    i_p = torch.exp(i_til - m_new)
    f_p = torch.exp(fm - m_new)
    c_new = f_p * c_prev + i_p * torch.tanh(z)
    n_new = f_p * n_prev + i_p
    h_out = torch.sigmoid(o) * c_new / torch.clamp(n_new, min=1.0)
    return h_out, (c_new, n_new, m_new)


def _groupnorm(x: torch.Tensor, scale: torch.Tensor, heads: int,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the feature axis. x: ``[..., D]``; the
    variance is the population one (``jnp.var``'s ``ddof=0``)."""
    if isinstance(x, shd.DTensor):
        # the head split needs whole features: each rank's batch rows
        return shd.on_batch_shards(
            lambda _b0, xl, sc: _groupnorm(xl, sc, heads, eps),
            x.shape[0], x, whole=(scale,))
    shp = x.shape
    xh = x.reshape(shp[:-1] + (heads, shp[-1] // heads)).float()
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale).to(x.dtype)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _mlstm_block(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[dict]):
    b, s, _ = x.shape
    nh = cfg.num_heads
    y = nn.rmsnorm(bp["ln"], x, cfg.norm_eps)
    up = shard(y @ bp["w_up"], "batch", None, "rnn")          # [B,S,di]
    z = y @ bp["w_z"]
    conv, new_tail = nn.causal_conv(
        bp["conv_w"], bp["conv_b"], up,
        state["conv"] if state is not None else None)
    cpath = F.silu(conv)
    di = up.shape[-1]
    hd = di // nh

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)       # [B,H,S,hd]

    q = heads(cpath @ bp["wq"]).float()
    k = heads(cpath @ bp["wk"]).float()
    v = heads(up @ bp["wv"]).float()
    # bf16 activation × f32 weight: an f32 product, as JAX promotes it.
    gates = shard(cpath.float() @ bp["w_if"] + bp["b_if"], "batch", None,
                  None)
    i_til = gates[..., :nh].transpose(1, 2)                   # [B,H,S]
    f_til = nn.log_sigmoid(gates[..., nh:]).transpose(1, 2)

    def scan(_b0, q, k, v, i_til, f_til, *state):
        bl = q.shape[0]
        if not state:
            state = (_zeros((bl, nh, hd, hd), q), _zeros((bl, nh, hd), q),
                     _zeros((bl, nh), q))
        outs = []
        for qt, kt, vt, it, ft in zip(q.unbind(2), k.unbind(2), v.unbind(2),
                                      i_til.unbind(2), f_til.unbind(2)):
            h_out, state = _mlstm_cell(qt, kt, vt, it, ft, state)
            outs.append(h_out)
        # [B,S,di]
        return (torch.stack(outs, dim=1).reshape(bl, s, di),) + state

    carry = () if state is None else (state["c"], state["n"], state["m"])
    h_seq, c_n, n_n, m_n = shd.on_batch_shards(scan, b, q, k, v, i_til,
                                               f_til, *carry)
    out = _groupnorm(h_seq.to(cfg.dtype), bp["gn"], nh)
    out = out * F.silu(z)
    x = x + out @ bp["w_down"]
    return shard(x, "batch", None, "embed"), {
        "conv": new_tail, "c": c_n, "n": n_n, "m": m_n}


def _slstm_block(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[dict]):
    b, s, d = x.shape
    y = nn.rmsnorm(bp["ln"], x, cfg.norm_eps)
    conv, new_tail = nn.causal_conv(
        bp["conv_w"], bp["conv_b"], y,
        state["conv"] if state is not None else None)
    cpath = F.silu(conv)
    # The bf16 products rounded, then the f32 biases added in f32.
    i_til = (cpath @ bp["w_i"]).float() + bp["b_i"]
    f_til = nn.log_sigmoid((cpath @ bp["w_f"]).float() + bp["b_f"])
    z = (y @ bp["w_z"]).float() + bp["b_z"]
    o = (y @ bp["w_o"]).float() + bp["b_o"]

    def scan(_b0, i_til, f_til, z, o, *state):
        if not state:
            bl = i_til.shape[0]
            state = (_zeros((bl, d), i_til), _zeros((bl, d), i_til),
                     _zeros((bl, d), i_til))
        outs = []
        for it, ft, zt, ot in zip(i_til.unbind(1), f_til.unbind(1),
                                  z.unbind(1), o.unbind(1)):
            h_out, state = _slstm_cell(it, ft, zt, ot, state)
            outs.append(h_out)
        return (torch.stack(outs, dim=1),) + state           # [B,S,D]

    carry = () if state is None else (state["c"], state["n"], state["m"])
    h_seq, c_n, n_n, m_n = shd.on_batch_shards(scan, b, i_til, f_til, z, o,
                                               *carry)
    out = _groupnorm(h_seq.to(cfg.dtype), bp["gn"], cfg.num_heads)
    x = x + out @ bp["w_down"]
    return shard(x, "batch", None, "embed"), {
        "conv": new_tail, "c": c_n, "n": n_n, "m": m_n}


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
             states: Optional[list] = None):
    x = nn.embed(params["embed"], tokens).to(cfg.dtype)
    remat = (cfg.remat == "full" and states is None
             and torch.is_grad_enabled())
    new_states = []
    for i, bp in enumerate(params["blocks"]):
        fn = _mlstm_block if block_kind(cfg, i) == "mlstm" else _slstm_block
        st = states[i] if states is not None else None
        if remat:
            x, ns = torch.utils.checkpoint.checkpoint(
                fn, bp, x, cfg, st, use_reentrant=False)
        else:
            x, ns = fn(bp, x, cfg, st)
        new_states.append(ns)
    return nn.rmsnorm(params["final_ln"], x, cfg.norm_eps), new_states


def xlstm_loss(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
               seq_weights: Optional[torch.Tensor] = None):
    """Weighted causal-LM loss (``layers.weighted_lm_loss``)."""
    h, _ = _forward(params, tokens, cfg)
    loss = nn.weighted_lm_loss(params["unembed"], h, tokens, seq_weights)
    return loss, {"loss": loss}


def xlstm_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The prompt's last f32 logits ``[B, 1, vocab]`` and the decode
    state: every block's conv tail and cell state, and the position."""
    h, states = _forward(params, tokens, cfg)
    logits = nn.unembed(params["unembed"], h[:, -1:])
    return logits, {"blocks": states, "position": torch.full(
        (), tokens.shape[1], dtype=torch.int32, device=tokens.device)}


def xlstm_decode_step(params: dict, state: dict, tokens: torch.Tensor,
                      cfg: ModelConfig):
    h, new_states = _forward(params, tokens, cfg, states=state["blocks"])
    logits = nn.unembed(params["unembed"], h)
    return logits, {"blocks": new_states, "position": state["position"] + 1}


def xlstm_init_decode_state(cfg: ModelConfig, batch: int,
                            device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    d, h = cfg.d_model, cfg.num_heads

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    states = []
    for i in range(cfg.num_layers):
        if block_kind(cfg, i) == "mlstm":
            di = 2 * d
            hd = di // h
            states.append({
                "conv": zeros((batch, cfg.conv_width - 1, di), cfg.dtype),
                "c": zeros((batch, h, hd, hd)),
                "n": zeros((batch, h, hd)),
                "m": zeros((batch, h)),
            })
        else:
            states.append({
                "conv": zeros((batch, cfg.conv_width - 1, d), cfg.dtype),
                "c": zeros((batch, d)),
                "n": zeros((batch, d)),
                "m": zeros((batch, d)),
            })
    return {"blocks": states, "position": zeros((), torch.int32)}
