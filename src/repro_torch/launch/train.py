"""End-to-end training driver with StreamApprox data-plane sampling.

Counterpart of the reference's ``launch/train.py``, with its flags,
defaults and output lines, plus ``--device`` (the card unless ``--device
cpu``). Per window: the aggregator emits candidate sequences stratified
by domain; OASRS samples ``batch`` of them with weights (the fold kernel
on the card, its plain version on the CPU, over int32 sequence indices);
the train step minimises the Horvitz–Thompson-weighted loss.
Checkpoints capture params, optimizer, OASRS state and the pipeline's
epoch cursor, in the reference's layout.

As the reference's, the batch holds ``tokens`` and ``weights`` only, so
the encdec and vlm families (whose loss also needs ``frames`` or
``patches``) cannot be trained through this CLI; their training goes
through ``train/train_step.make_train_step`` with a batch that carries
them.

Usage (CPU-scale demo):
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --smoke --steps 20 --sampling-fraction 0.5 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs as cfgs
from repro_torch import prng
from repro_torch.core import oasrs
from repro_torch.models import api
from repro_torch.models.param import init_params
from repro_torch.stream.pipeline import (Prefetcher, TokenWindowSpec,
                                         synthetic_token_window)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass
class RunConfig:
    arch: str = "xlstm-350m"
    smoke: bool = True
    steps: int = 20
    batch: int = 8
    seq_len: int = 128
    num_domains: int = 8
    sampling_fraction: float = 0.5   # batch = fraction × window
    checkpoint_dir: str = ""
    checkpoint_every: int = 10
    seed: int = 0


def sample_window(res_state: oasrs.OASRSState, tokens: torch.Tensor,
                  domains: torch.Tensor):
    """Fold one window into OASRS and extract the training sample:
    ``(state, sequence indices, weights, valid)`` over the flattened
    reservoirs. The reservoir tensor is written in place."""
    idx = torch.arange(tokens.shape[0], dtype=torch.int32,
                       device=tokens.device)
    res_state = oasrs.reset_window(res_state)
    res_state = oasrs.update_chunk(res_state, domains, idx)
    sel_idx, w, valid = oasrs.sample_with_weights(res_state)
    return res_state, sel_idx, w, valid


def assemble_batch(tokens: torch.Tensor, sel_idx: torch.Tensor,
                   w: torch.Tensor, valid: torch.Tensor, batch: int) -> dict:
    """Pick ``batch`` sampled sequences, valid slots first (a stable
    order, as the reference's ``argsort``). An invalid slot's stale index
    is clamped into the window, as JAX clamps a gather (its weight is 0).
    The reference's unused ``key`` argument is dropped."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    pick = order[:batch]
    idx = torch.clamp(sel_idx[pick].long(), 0, tokens.shape[0] - 1)
    weights = torch.where(valid[pick], w[pick], 0.0)
    return {"tokens": tokens[idx], "weights": weights}


def train(run: RunConfig, device: DeviceLike = None,
          log=print) -> list:
    """Train for ``run.steps`` windows; returns the losses. On the card
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    cfg = cfgs.get_config(run.arch, smoke=run.smoke)
    spec = TokenWindowSpec(
        window_sequences=int(run.batch / run.sampling_fraction),
        seq_len=run.seq_len, num_domains=run.num_domains,
        vocab_size=cfg.vocab_size)

    key = prng.PRNGKey(run.seed, device=dev)
    params = init_params(api.skeleton(cfg), key, device=dev)
    opt_cfg = opt.OptConfig(warmup_steps=10)
    state = opt.init_state(params, None, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)

    # Per-domain reservoirs sized so Σ N_i ≈ batch.
    cap = max(run.batch // run.num_domains, 1)
    res = oasrs.init(run.num_domains, cap, prng.fold_in(key, 1),
                     max_capacity=4 * cap,
                     payload_spec=oasrs.PayloadSpec(dtype=torch.int32),
                     device=dev)

    ckpt = (ckpt_lib.AsyncCheckpointer(run.checkpoint_dir)
            if run.checkpoint_dir else None)
    start_epoch = 0
    if ckpt and (last := ckpt_lib.latest_step(run.checkpoint_dir)) is not None:
        tree = {"state": state, "res": res,
                "epoch": torch.zeros((), dtype=torch.int32, device=dev)}
        tree = ckpt_lib.restore(run.checkpoint_dir, last, tree)
        state, res = tree["state"], tree["res"]
        start_epoch = int(tree["epoch"]) + 1
        log(f"[train] restored checkpoint step {last} "
            f"(epoch {start_epoch})")

    pf = Prefetcher(lambda e: synthetic_token_window(spec, e, run.seed,
                                                     device=dev),
                    start_epoch=start_epoch)
    losses = []
    try:
        for i in range(run.steps):
            epoch, (tokens, domains) = pf.next()
            t0 = time.perf_counter()
            res, sel_idx, w, valid = sample_window(res, tokens, domains)
            batch = assemble_batch(tokens, sel_idx, w, valid, run.batch)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            log(f"[train] step {int(state.step):4d} epoch {epoch} "
                f"loss {loss:.4f} grad_norm "
                f"{float(metrics['grad_norm']):.3f} ({dt*1e3:.0f} ms, "
                f"window {spec.window_sequences} → batch {run.batch})")
            if ckpt and (i + 1) % run.checkpoint_every == 0:
                ckpt.save(int(state.step), {
                    "state": state, "res": res,
                    "epoch": torch.tensor(epoch, dtype=torch.int32)})
    finally:
        pf.close()
        if ckpt:
            ckpt.wait()
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m", choices=list(cfgs.ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--sampling-fraction", type=float, default=0.5)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    run = RunConfig(arch=args.arch, smoke=args.smoke, steps=args.steps,
                    batch=args.batch, seq_len=args.seq_len,
                    sampling_fraction=args.sampling_fraction,
                    checkpoint_dir=args.checkpoint_dir)
    losses = train(run, device=args.device)
    print(f"[train] done; loss {losses[0]:.4f} → {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    main()
