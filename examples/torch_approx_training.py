"""End-to-end driver: approximate TRAINING with StreamApprox, on the port.

The PyTorch/CUDA counterpart of ``examples/approx_training.py``: trains a
dense LM where each step's batch is OASRS-sampled from an arriving window
of candidate sequences (strata = data domains) and the loss is
Horvitz–Thompson weighted: the paper's accuracy⇄throughput dial applied
to pretraining.

Default is a CPU-friendly reduced run; ``--full-100m`` uses a ~100M
config and a few hundred steps. Runs on the card unless ``--device cpu``.
Checkpoints go to a directory under the system's temporary directory.

Run:  PYTHONPATH=src python examples/torch_approx_training.py --device cpu
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile
import time

import torch

from repro_torch.launch.train import RunConfig, train
from repro_torch.models.config import ModelConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--sampling-fraction", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    ckpt_dir = os.path.join(tempfile.gettempdir(),
                            "repro_torch_approx_training")

    if args.full_100m:
        # ~100M params: 8L × d512 × ff2048, 32k vocab
        run = RunConfig(arch="phi4-mini-3.8b", smoke=True,
                        steps=args.steps or 300, batch=8, seq_len=256,
                        sampling_fraction=args.sampling_fraction,
                        checkpoint_dir=ckpt_dir)
        # override the smoke config with the 100M one
        import repro_torch.configs.phi4_mini_3_8b as mod
        mod.SMOKE = ModelConfig(
            name="phi4-100m", family="dense", num_layers=8, d_model=512,
            num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32_768, attn_q_chunk=256, attn_kv_chunk=256,
            remat="none", dtype=torch.float32)
    else:
        run = RunConfig(arch="phi4-mini-3.8b", smoke=True,
                        steps=args.steps or 30, batch=8, seq_len=128,
                        sampling_fraction=args.sampling_fraction,
                        checkpoint_dir=ckpt_dir)

    t0 = time.time()
    losses = train(run, device=args.device)
    dt = time.time() - t0
    print(f"\n[approx-training] fraction={run.sampling_fraction} "
          f"steps={run.steps} wall={dt:.1f}s "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f}")
    print("[approx-training] the same window stream at fraction=1.0 would "
          f"process {1 / run.sampling_fraction:.1f}× the sequences/step — "
          "that is the paper's throughput⇄accuracy dial on the train step.")


if __name__ == "__main__":
    main()
