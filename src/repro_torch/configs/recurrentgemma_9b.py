"""recurrentgemma-9b [hybrid] — 38 blocks d_model=4096 16H (MQA kv=1)
d_ff=12288 — RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427; unverified]

Sub-quadratic: RG-LRU state is O(1)/layer and attention is local
(window=2048) → this arch RUNS the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    mlp_activation="geglu", block_pattern=("rec", "rec", "attn"),
    rnn_width=4096, conv_width=4, local_window=2048,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, rnn_width=64, local_window=16,
    attn_q_chunk=16, attn_kv_chunk=16, remat="none",
)
