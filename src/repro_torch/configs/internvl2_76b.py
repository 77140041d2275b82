"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT frontend + InternLM2 backbone.
[arXiv:2404.16821; unverified]

The InternViT frontend is a STUB per the assignment: ``input_specs()``
provides 256 precomputed patch embeddings [B, 256, d_model] prepended to
the text tokens; text length = seq_len − 256 so total positions = seq_len.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=28672, vocab_size=128256, num_patches=256,
    mlp_activation="swiglu",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, num_patches=8,
    attn_q_chunk=32, attn_kv_chunk=32, remat="none",
)
