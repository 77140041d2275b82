"""VLM (InternVL2-76B backbone): vision patches + decoder-only LM.

Counterpart of the reference's ``models/vlm.py``. The InternViT frontend
is a stub, as there: ``patches [B, P, d_model]`` are precomputed patch
embeddings, prepended to the token embeddings; the loss covers text
positions only. Everything else (GQA attention, the KV cache, decode) is
the dense stack of ``models/transformer``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import kvcache as kvc
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


def vlm_skeleton(cfg: ModelConfig) -> dict:
    return tr.lm_skeleton(cfg)


def vlm_loss(params: dict, tokens: torch.Tensor, patches: torch.Tensor,
             cfg: ModelConfig, seq_weights: Optional[torch.Tensor] = None):
    """tokens: ``[B, S_text]``; patches: ``[B, P, d_model]``."""
    return tr.lm_loss(params, tokens, cfg, seq_weights=seq_weights,
                      extra_embeds=patches)


def vlm_prefill(params: dict, tokens: torch.Tensor, patches: torch.Tensor,
                cfg: ModelConfig, max_len: int = 0):
    """Logits of the last text token and a KV cache over the ``P`` patch
    and ``S`` text positions (its position ``P + S``)."""
    return tr.prefill(params, tokens, cfg, max_len=max_len,
                      extra_embeds=patches)


def vlm_decode_step(params: dict, cache: kvc.KVCache, tokens: torch.Tensor,
                    cfg: ModelConfig):
    return tr.decode_step(params, cache, tokens, cfg)
