"""seamless-m4t-large-v2 [audio enc-dec] — 24L(enc)+24L(dec) d_model=1024
16H (MHA kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596; hf]

The speech frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings [B, F=seq_len, d_model] feeding the
conformer-less encoder; the transformer BACKBONE is what is modeled.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, num_encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, head_dim=64, d_ff=8192, vocab_size=256206,
    mlp_activation="swiglu",
)

SMOKE = CONFIG.replace(
    num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    attn_q_chunk=32, attn_kv_chunk=32, remat="none",
)
