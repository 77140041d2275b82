"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) expert_d_ff=2048
vocab=163840, MoE 384 experts top-8 + 1 shared, first layer dense.

[arXiv:2501.kimi2; unverified — paper-table trillion-param MoE]. The
assignment specifies GQA kv=8 (not MLA); head_dim=128 (K2 uses head_dim
independent of d_model/H).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=18432, vocab_size=163840,
    num_experts=384, num_experts_per_token=8, num_shared_experts=1,
    expert_d_ff=2048, first_dense_layers=1,
    mlp_activation="swiglu",
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, num_experts=8, num_experts_per_token=2,
    num_shared_experts=1, expert_d_ff=32, first_dense_layers=1,
    attn_q_chunk=32, attn_kv_chunk=32, remat="none",
)
