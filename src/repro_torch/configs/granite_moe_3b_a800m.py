"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8)
expert_d_ff=512 vocab=49155, MoE 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]. NOTE: the assignment's
structured field says 40 experts while its free-text comment says 32 — we
follow the structured field (40e); the SMOKE config shrinks to 8e anyway.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    head_dim=64, d_ff=0, vocab_size=49155,
    num_experts=40, num_experts_per_token=8, expert_d_ff=512,
    mlp_activation="swiglu",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    vocab_size=512, num_experts=8, num_experts_per_token=2, expert_d_ff=32,
    attn_q_chunk=32, attn_kv_chunk=32, remat="none",
)
