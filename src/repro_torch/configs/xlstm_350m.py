"""xlstm-350m [ssm] — 24 blocks d_model=1024 4H d_ff=0 vocab=50304 —
alternating sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

d_ff=0: blocks carry their own up/down projections, no separate FFN.
Linear-state recurrences → O(1) decode state → runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    head_dim=256, d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"), conv_width=4,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    vocab_size=512, remat="none",
)
