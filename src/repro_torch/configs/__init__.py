"""Architecture registry: ``--arch <id>`` → (CONFIG, SMOKE)."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

ARCHS = tuple(_MODULES)

#: Input-shape cells shared by all LM archs: name → (seq_len, global_batch).
SHAPES = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}

#: Archs with sub-quadratic sequence mixing — the only ones that run
#: long_500k (full-attention archs skip it; DESIGN.md §5).
SUBQUADRATIC = ("recurrentgemma-9b", "xlstm-350m")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def cell_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """Whether (arch × shape) runs, with the skip reason if not."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("full-attention arch: 500k-token decode needs "
                       "sub-quadratic attention (skip noted in DESIGN.md §5)")
    return True, ""
