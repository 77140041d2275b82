"""The card a run uses: whether it is there, its name, power limit and
memory peak."""
from __future__ import annotations

import subprocess


class RunRefused(RuntimeError):
    """The run cannot give a result (no card, too few cards, ...)."""


def card(chips: int):
    """The device the run uses: card 0, once torch sees ``chips`` cards
    (its memory peak counted from here)."""
    import torch
    if not torch.cuda.is_available():
        raise RunRefused("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise RunRefused(f"{torch.cuda.device_count()} cards, the cell "
                         f"asks for {chips}")
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    return torch.device("cuda", 0)


def power_limit() -> str:
    """``name, power.limit`` of every card as ``nvidia-smi`` reads them
    (``not read`` where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def describe(torch, chips: int, memory_peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak)}
