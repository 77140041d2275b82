"""Shared neural layers: norms, MLPs, embeddings (functional style).

Counterpart of the reference's ``models/layers.py``. Every function takes
its params (a dict of tensors) explicitly. The reference's sharding
annotations have no meaning on one card and are dropped.

Where the reference asks its dot for f32 results from bf16 operands
(``preferred_element_type=jnp.float32``), :func:`dot_f32` gives them:
on the card through cuBLAS with an f32 output (``torch.bmm(...,
out_dtype=torch.float32)``) inside an autograd function of its own, on
the CPU by upcasting the operands (the products of bf16 values are exact
in f32 either way; both accumulate in f32).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec


class _DotF32(torch.autograd.Function):
    """``a @ b`` (2-D or batched 3-D, one low-precision dtype) with an f32
    result from cuBLAS. The backward is the transpose JAX takes of
    ``einsum(..., preferred_element_type=f32)``: each operand's cotangent
    is the f32 cotangent against the other operand, cast to the operand's
    dtype. The cotangent is rounded to the operands' dtype before its two
    products (cuBLAS multiplies one dtype), so no f32 copy of an operand
    (the 1.23 GB unembedding at phi4-mini's width) is ever made; the
    products accumulate in f32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = g @ b.transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            gb = a.transpose(-1, -2) @ g
        return ga, gb


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D or 3-D (batched) operands of one dtype, with an
    f32 result; differentiable."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    return _DotF32.apply(a, b)


def scalar_in(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` as a Python float: the reference's
    ``jnp.asarray(x, dtype)`` factor."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    (``F.softplus`` switches to ``x`` above a threshold instead)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_skeleton(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# MLPs   (RoPE lives in models/attention.py — interleaved variant)
# ---------------------------------------------------------------------------

def mlp_skeleton(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.mlp_activation in ("swiglu", "geglu")
    skel = {
        "w_in": ParamSpec((d, f), ("embed_tp", "mlp"), dtype=cfg.dtype),
        "w_out": ParamSpec((f, d), ("mlp", "embed_tp"), dtype=cfg.dtype),
    }
    if gated:
        skel["w_gate"] = ParamSpec((d, f), ("embed_tp", "mlp"),
                                   dtype=cfg.dtype)
    return skel


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ params["w_in"]
    if cfg.mlp_activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * h
    elif cfg.mlp_activation == "geglu":
        # jax.nn.gelu's default is the tanh approximation.
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * h
    elif cfg.mlp_activation == "relu2":      # nemotron-4 squared ReLU
        r = F.relu(h)
        h = r * r
    elif cfg.mlp_activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_activation)
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_skeleton(cfg: ModelConfig) -> dict:
    return {
        "tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed_tp"), dtype=cfg.dtype,
                            init="normal", scale=0.02),
    }


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tokens"][tokens.long()]


def unembed_skeleton(cfg: ModelConfig) -> dict:
    return {
        "w": ParamSpec((cfg.d_model, cfg.vocab_size),
                       ("embed_tp", "vocab"), dtype=cfg.dtype),
    }


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``[B, S, D] → [B, S, vocab]`` f32 logits straight out of the dot
    (on the card never a bf16 ``[B, S, vocab]`` tensor or an f32 copy of
    ``w``)."""
    b, s, d = x.shape
    return dot_f32(x.reshape(b * s, d), params["w"]).view(b, s, -1)


# ---------------------------------------------------------------------------
# Shared by the recurrent families (models/xlstm.py, models/rglru.py)
# ---------------------------------------------------------------------------

def causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width ``K = w.shape[0]`` over ``x [B, S,
    C]``; ``tail``: ``[B, K-1, C]`` carried inputs (decode), zeros if
    None. The taps are summed in order in x's dtype, as the reference's
    Python ``sum``. Returns (y, the new tail)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y + b, xp[:, -(k - 1):]


def weighted_lm_loss(unembed_params: dict, h: torch.Tensor,
                     tokens: torch.Tensor,
                     seq_weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``Σ_b w_b ℓ̄_b / Σ_b w_b`` from the final hidden states ``h [B, S,
    D]`` of the whole-length inputs: targets the tokens rolled by one,
    the last position masked (the reference's ``xlstm_loss`` and
    ``rg_loss``)."""
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    logits = unembed(unembed_params, h)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    per_seq = torch.sum((lse - picked) * mask, dim=1) / torch.clamp(
        torch.sum(mask, dim=1), min=1.0)
    w = (seq_weights if seq_weights is not None
         else torch.ones_like(per_seq)).to(torch.float32)
    return torch.sum(w * per_seq) / torch.clamp(torch.sum(w), min=1e-9)
