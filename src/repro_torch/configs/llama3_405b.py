"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783; unverified]

With TP=16 the 8 KV heads are replicated ×2 per device (divisibility rule
in distributed/sharding.py); Q heads shard 128/16 = 8 per device.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    head_dim=128, d_ff=53248, vocab_size=128256,
    mlp_activation="swiglu",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=512, attn_q_chunk=32, attn_kv_chunk=32,
    remat="none",
)
