"""Unified model API: one entry point per (family × phase).

Counterpart of the reference's ``models/api.py`` for the dense family:
``loss_fn(cfg)(params, batch) -> (loss, metrics)`` for training,
``prefill_fn(cfg)(params, batch) -> (logits, state)`` and
``decode_fn(cfg)(params, state, tokens) -> (logits, state)`` for serving,
the state a :class:`~repro_torch.models.kvcache.KVCache`.

``batch`` layout (training): ``tokens [B, S]`` and, optionally,
``weights [B]``, the OASRS stratum weights ``W_i`` per sequence. The other
families (moe, encdec, vlm, hybrid, ssm) raise
:class:`~repro_torch.models.transformer.UnportedModelError` (ROADMAP
item 12c).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import kvcache as kvc
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.utils import DeviceLike


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise tr.UnportedModelError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP item 12c); the port runs the dense family")
    tr.refuse_moe(cfg)


def skeleton(cfg: ModelConfig) -> dict:
    _dense_only(cfg)
    return tr.lm_skeleton(cfg)


def loss_fn(cfg: ModelConfig) -> Callable:
    """Returns ``f(params, batch) -> (loss, metrics)``."""
    _dense_only(cfg)

    def f(params, batch):
        return tr.lm_loss(params, batch["tokens"], cfg,
                          seq_weights=batch.get("weights"))
    return f


def prefill_fn(cfg: ModelConfig) -> Callable:
    """Returns ``f(params, batch, max_len=0) -> (logits, serve_state)``."""
    _dense_only(cfg)

    def f(params, batch, max_len: int = 0):
        return tr.prefill(params, batch["tokens"], cfg, max_len=max_len)
    return f


def decode_fn(cfg: ModelConfig) -> Callable:
    """Returns ``f(params, state, tokens) -> (logits, state)``."""
    _dense_only(cfg)

    def f(params, state, tokens):
        return tr.decode_step(params, state, tokens, cfg)
    return f


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device: DeviceLike = None) -> kvc.KVCache:
    """Zero decode state with a saturated-length cache (``cache_len +
    16`` slots, position ``cache_len``), as the reference's."""
    _dense_only(cfg)
    cache = kvc.init_cache(cfg, cfg.num_layers, batch, cache_len + 16,
                           device=device)
    return dataclasses.replace(cache, position=torch.full(
        (), cache_len, dtype=torch.int32, device=cache.k.device))
