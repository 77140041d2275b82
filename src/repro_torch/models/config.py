"""Unified model configuration covering the 10 architectures.

Counterpart of the reference's ``models/config.py``, field for field (the
knobs only the XLA paths read, ``remat``, ``scan_layers``,
``sp_residual``, ``pure_dp``, ``attn_unroll`` and ``time_unroll``, are
kept so configs compare field by field); ``dtype`` is a torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | encdec | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_token: int = 0
    num_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # leading dense layers (kimi-k2 style)
    reservoir_routing: bool = False  # OASRS-fair capacity overflow drops

    # --- MLP / norm ---
    mlp_activation: str = "swiglu"   # swiglu | relu2 | geglu | gelu
    norm_eps: float = 1e-5

    # --- positional ---
    rope_theta: float = 10000.0

    # --- hybrid (RG-LRU) / ssm (xLSTM) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ('rec','rec','attn')
    rnn_width: int = 0
    conv_width: int = 4
    local_window: int = 2048

    # --- encoder-decoder / multimodal frontends (stubs) ---
    num_encoder_layers: int = 0
    num_frames: int = 0              # audio frames fed to the encoder
    num_patches: int = 0             # vision patches prepended to the LM

    # --- compute/impl knobs (perf surface for §Perf) ---
    dtype: Any = torch.bfloat16
    attn_q_chunk: int = 1024         # query-block size of chunked attention
    attn_kv_chunk: int = 1024
    logit_chunk: int = 0             # 0 = loss over full logits
    remat: str = "full"              # none | full
    scan_layers: bool = True
    sp_residual: bool = False        # Megatron-SP: residual stream sharded
                                     # over (batch, seq); psums become
                                     # reduce-scatter+all-gather pairs
    pure_dp: bool = False            # small-model mode: batch shards over
                                     # pod×data×model (no TP), optimizer
                                     # ZeRO over all 256/512 chips — right
                                     # for models whose params fit one chip
    # Cost-probe knobs (launch/roofline.py): replace lax.scan with Python
    # unrolling so cost_analysis counts every iteration (XLA costs a scan
    # body ONCE regardless of trip count).
    attn_unroll: bool = False        # unroll the kv-block online-softmax scan
    time_unroll: bool = False        # unroll recurrent time scans (ssm)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
