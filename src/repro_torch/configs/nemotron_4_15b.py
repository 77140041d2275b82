"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — squared-ReLU MLP (ungated). [arXiv:2402.16819; unverified]

The 256k vocab makes the embedding/logits path the memory hotspot; the
unembed is vocab-sharded and the loss supports seq-chunking (§Perf lever).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=256000,
    mlp_activation="relu2",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, attn_q_chunk=32, attn_kv_chunk=32,
    remat="none",
)
