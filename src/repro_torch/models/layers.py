"""Shared neural layers: norms, MLPs, embeddings (functional style).

Counterpart of the reference's ``models/layers.py``. Every function takes
its params (a dict of tensors) explicitly. The reference's sharding
annotations are kept (``distributed/sharding.shard``: no-ops without a
mesh).

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

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import shard
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
    if a.dtype == torch.float32 or not shd.f32_out_products(a.device):
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


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x ``[B, S, K]`` and w ``[K, N]``; on ``DTensor`` s each
    rank multiplies its own shards (``sharding.local_product``): the
    Megatron plan, column- or row-parallel by w's placement, rather than
    the strategy ``DTensor`` would pick for the product and its
    backward (which differs between torch releases)."""
    if isinstance(w, shd.DTensor):
        return shd.local_product(x, w, (w.shape[1],),
                                 lambda xl, wl: xl @ wl)
    return x @ w


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = shard(_matmul(x, params["w_in"]), "batch", None, "mlp")
    if cfg.mlp_activation == "swiglu":
        h = F.silu(_matmul(x, params["w_gate"])) * h
    elif cfg.mlp_activation == "geglu":
        # jax.nn.gelu's default is the tanh approximation.
        h = F.gelu(_matmul(x, params["w_gate"]), approximate="tanh") * h
    elif cfg.mlp_activation == "relu2":      # nemotron-4 squared ReLU
        r = F.relu(h)
        h = r * r
    elif cfg.mlp_activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_activation)
    return shard(_matmul(h, params["w_out"]), "batch", None, "embed")


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
    table = params["tokens"]
    if isinstance(table, shd.DTensor):
        return shard(_local_embed(table, tokens), "batch", None, "embed")
    return shard(table[tokens.long()], "batch", None, "embed")


def _local_embed(table, tokens):
    """Vocab-parallel lookup: each rank gathers the rows of its vocab
    slice (zeros for tokens outside it), a pending sum over the mesh dims
    that split the vocab."""
    from torch.distributed.tensor import Partial, Shard
    mesh = table.device_mesh
    spec = shd.resolve_spec(("batch", None), tokens.shape, mesh)
    rows = list(shd.placements(spec, mesh))
    out = [Partial() if isinstance(tp, Shard) and tp.dim == 0 else rp
           for rp, tp in zip(rows, table.placements)]
    tl = tokens.redistribute(mesh, rows).to_local().long()
    wl = shd.local(table, out)
    v0 = shd.local_shape_and_offset(table)[1][0]
    idx = tl - v0
    inside = (idx >= 0) & (idx < wl.shape[0])
    got = F.embedding(torch.clamp(idx, 0, wl.shape[0] - 1), wl)
    got = got * inside.unsqueeze(-1).to(got.dtype)
    return shd.from_local(got, tuple(tokens.shape) + (wl.shape[1],), mesh,
                          out)


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
    w = params["w"]
    if isinstance(w, shd.DTensor):
        logits = shd.local_product(x, w, (w.shape[1],), lambda xl, wl: dot_f32(
            xl.reshape(-1, d), wl).view(xl.shape[0], s, -1))
    else:
        logits = dot_f32(x.reshape(b * s, d), w).view(b, s, -1)
    return shard(logits, "batch", None, "vocab")


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


def next_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """The targets of a causal LM loss: ``tokens [B, S]`` rolled by one
    along the sequence (the last position is masked by the caller). On a
    ``DTensor`` each rank rolls its own rows."""
    if isinstance(tokens, shd.DTensor):
        return shd.on_batch_shards(
            lambda _b0, t: torch.roll(t, -1, dims=1), tokens.shape[0],
            tokens)
    return torch.roll(tokens, -1, dims=1)


def xent_parts(logits: torch.Tensor, targets: torch.Tensor) -> tuple:
    """``(logsumexp(logits), logits[target])`` over the last dim, each
    ``[B, S]`` f32. On ``DTensor`` logits (vocab-sharded), each rank works
    on its vocab slice: local max, sum of exponents and picked logit,
    combined by all-reduces over the mesh dims that split the vocab (the
    whole ``[B, S, vocab]`` logits are never gathered)."""
    if not isinstance(logits, shd.DTensor):
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return lse, picked
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    want = shd.placements(shd.resolve_spec(
        ("batch", None, "vocab"), logits.shape, mesh), mesh)
    logits = logits.redistribute(mesh, want)
    vdims = [i for i, pl in enumerate(want)
             if isinstance(pl, Shard) and pl.dim == 2]
    rows = [pl if isinstance(pl, Shard) and pl.dim < 2 else Replicate()
            for pl in want]
    ll = logits.to_local()
    tl = targets.redistribute(mesh, rows).to_local().long()
    v0 = shd.local_shape_and_offset(logits)[1][2]

    def reduce(t, op):
        return shd.all_reduce(t, op, mesh, vdims)
    m = reduce(torch.amax(ll.detach(), dim=-1), "max")   # a constant shift
    lse = torch.log(reduce(torch.sum(torch.exp(ll - m[..., None]), dim=-1),
                           "sum")) + m
    idx = tl - v0
    inside = (idx >= 0) & (idx < ll.shape[-1])
    got = torch.gather(ll, -1, torch.clamp(idx, 0, ll.shape[-1] - 1)
                       .unsqueeze(-1))[..., 0]
    picked = reduce(torch.where(inside, got, torch.zeros_like(got)), "sum")
    shape = tuple(logits.shape[:2])
    return (shd.from_local(lse, shape, mesh, rows),
            shd.from_local(picked, shape, mesh, rows))


def weighted_lm_loss(unembed_params: dict, h: torch.Tensor,
                     tokens: torch.Tensor,
                     seq_weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``Σ_b w_b ℓ̄_b / Σ_b w_b`` from the final hidden states ``h [B, S,
    D]`` of the whole-length inputs: targets the tokens rolled by one,
    the last position masked (the reference's ``xlstm_loss`` and
    ``rg_loss``)."""
    targets = next_tokens(tokens)
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    lse, picked = xent_parts(unembed(unembed_params, h), targets)
    per_seq = torch.sum((lse - picked) * mask, dim=1) / torch.clamp(
        torch.sum(mask, dim=1), min=1.0)
    w = (seq_weights if seq_weights is not None
         else torch.ones_like(per_seq)).to(torch.float32)
    return torch.sum(w * per_seq) / torch.clamp(torch.sum(w), min=1e-9)
