"""Unified model API: one entry point per (family × phase).

Counterpart of the reference's ``models/api.py`` for the decoder-only
families: dense and moe (``models/transformer``), hybrid
(``models/rglru``) and ssm (``models/xlstm``).
``loss_fn(cfg)(params, batch) -> (loss, metrics)`` for training,
``prefill_fn(cfg)(params, batch) -> (logits, state)`` and
``decode_fn(cfg)(params, state, tokens) -> (logits, state)`` for serving;
the state is a :class:`~repro_torch.models.kvcache.KVCache` for dense and
moe, a dict of per-block states and the position for hybrid and ssm.

``batch`` layout (training): ``tokens [B, S]`` and, optionally,
``weights [B]``, the OASRS stratum weights ``W_i`` per sequence. The
families with a frontend stub (encdec, vlm) raise
:class:`~repro_torch.models.transformer.UnportedModelError` (ROADMAP
item 12c).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import kvcache as kvc
from repro_torch.models import rglru as rg
from repro_torch.models import transformer as tr
from repro_torch.models import xlstm as xl
from repro_torch.models.config import ModelConfig
from repro_torch.utils import DeviceLike

#: The families the port runs.
PORTED = ("dense", "moe", "hybrid", "ssm")


def _ported(cfg: ModelConfig) -> None:
    if cfg.family in ("encdec", "vlm"):
        raise tr.UnportedModelError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP item 12c); the port runs {', '.join(PORTED)}")
    if cfg.family not in PORTED:
        raise ValueError(cfg.family)


def skeleton(cfg: ModelConfig) -> dict:
    _ported(cfg)
    if cfg.family == "hybrid":
        return rg.rg_skeleton(cfg)
    if cfg.family == "ssm":
        return xl.xlstm_skeleton(cfg)
    return tr.lm_skeleton(cfg)


def loss_fn(cfg: ModelConfig) -> Callable:
    """Returns ``f(params, batch) -> (loss, metrics)``."""
    _ported(cfg)
    loss = {"hybrid": rg.rg_loss, "ssm": xl.xlstm_loss}.get(
        cfg.family, tr.lm_loss)

    def f(params, batch):
        return loss(params, batch["tokens"], cfg,
                    seq_weights=batch.get("weights"))
    return f


def prefill_fn(cfg: ModelConfig) -> Callable:
    """Returns ``f(params, batch, max_len=0) -> (logits, serve_state)``
    (``max_len`` sizes the dense and moe KV cache; the recurrent states
    of hybrid and ssm have no length, as in the reference)."""
    _ported(cfg)
    if cfg.family in ("hybrid", "ssm"):
        prefill = rg.rg_prefill if cfg.family == "hybrid" \
            else xl.xlstm_prefill

        def f(params, batch, max_len: int = 0):
            return prefill(params, batch["tokens"], cfg)
        return f

    def f(params, batch, max_len: int = 0):
        return tr.prefill(params, batch["tokens"], cfg, max_len=max_len)
    return f


def decode_fn(cfg: ModelConfig) -> Callable:
    """Returns ``f(params, state, tokens) -> (logits, state)``."""
    _ported(cfg)
    decode = {"hybrid": rg.rg_decode_step,
              "ssm": xl.xlstm_decode_step}.get(cfg.family, tr.decode_step)

    def f(params, state, tokens):
        return decode(params, state, tokens, cfg)
    return f


def state_tree(state) -> dict:
    """A serving state as a tree of tensors: a KV cache's (any object with
    the cache's ``k``, ``v``, ``position`` and ``window``) three tensors,
    or the hybrid and ssm families' dict as it is."""
    if hasattr(state, "window"):
        return {"k": state.k, "v": state.v, "position": state.position}
    return state


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device: DeviceLike = None):
    """Family-specific zero decode state at position ``cache_len``: for
    dense and moe a cache of ``cache_len + 16`` slots, for hybrid and ssm
    the zero recurrent states (a saturated O(1) state), as the
    reference's."""
    _ported(cfg)
    if cfg.family in ("hybrid", "ssm"):
        init = rg.rg_init_decode_state if cfg.family == "hybrid" \
            else xl.xlstm_init_decode_state
        st = init(cfg, batch, device=device)
        st["position"].fill_(cache_len)
        return st
    cache = kvc.init_cache(cfg, cfg.num_layers, batch, cache_len + 16,
                           device=device)
    return dataclasses.replace(cache, position=torch.full(
        (), cache_len, dtype=torch.int32, device=cache.k.device))
