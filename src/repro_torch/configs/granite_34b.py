"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]

MQA: the single KV head is replicated across the TP axis.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    head_dim=128, d_ff=24576, vocab_size=49152,
    mlp_activation="swiglu",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, attn_q_chunk=32, attn_kv_chunk=32,
    remat="none",
)
