"""Training step: the OASRS-weighted loss, microbatching, the update.

Counterpart of the reference's ``train/train_step.py``. The data plane
hands the step ``global_batch`` sequences sampled by OASRS from the
arriving window, with their stratum weights ``W_i``; the loss is the
Horvitz–Thompson ratio estimator, so its gradient is an unbiased
estimate of the full-stream gradient at a fraction of the work: the
paper's throughput⇄accuracy dial applied to training.

Gradients come from autograd on detached, grad-requiring views of the
params (no ``.grad`` is ever accumulated on the state's tensors).
:func:`shard_batch` places the batch's leading dim over the data axes
under a mesh (the reference's ``shard_batch``; a no-op without one).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import shard
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import leaves, map_tree
from repro_torch.train import optimizer as opt


def shard_batch(batch: dict) -> dict:
    """Every leaf of rank >= 1 placed with its leading dim over
    ``batch``."""
    def ann(x):
        if x.dim() >= 1:
            return shard(x, *(["batch"] + [None] * (x.dim() - 1)))
        return x
    return {k: ann(v) for k, v in batch.items()}


def _grads(loss_fn: Callable, params: dict, batch: dict):
    """``(loss, metrics, grads)`` of one batch; grads in the params'
    dtypes, a tree like ``params``."""
    live = map_tree(lambda _p, t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        flat = [t for _, t in leaves(live)]
        got = torch.autograd.grad(loss, flat)
    index = {p: g for (p, _), g in zip(leaves(live), got)}
    return loss.detach(), metrics, map_tree(lambda p, _t: index[p], live)


def make_train_step(cfg: ModelConfig, opt_cfg: opt.OptConfig,
                    num_microbatches: int = 1) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``num_microbatches > 1`` splits the batch and runs the microbatches
    in order, accumulating each one's grads in f32 weighted by its
    ``Σw`` (its sequence count without weights), so the loss and the
    grads are the same ratio estimator as the unsplit batch's. The grads
    are cast to the params' dtypes before :func:`~repro_torch.train.
    optimizer.apply_updates`, which updates the state in place.
    """
    loss_fn = api.loss_fn(cfg)

    def train_step(state: opt.TrainState, batch: dict):
        batch = shard_batch(batch)
        if num_microbatches == 1:
            loss, metrics, grads = _grads(loss_fn, state.params, batch)
        else:
            b = batch["tokens"].shape[0]
            mb = b // num_microbatches
            acc, loss_num, denom = None, None, None
            for i in range(num_microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                w = part.get("weights")
                wsum = (torch.sum(w) if w is not None else torch.tensor(
                    float(mb), device=part["tokens"].device))
                loss, _, grads = _grads(loss_fn, state.params, part)
                if acc is None:
                    acc = map_tree(lambda _p, g: g.to(torch.float32) * wsum,
                                   grads)
                    loss_num, denom = loss * wsum, wsum
                else:
                    for (_, a), (_, g) in zip(leaves(acc), leaves(grads)):
                        a.add_(g.to(torch.float32) * wsum)
                    loss_num, denom = loss_num + loss * wsum, denom + wsum
                del grads
            d = torch.clamp(denom, min=1e-9)
            loss = loss_num / d
            grads = map_tree(lambda _p, g: g.div_(d), acc)
            metrics = {"loss": loss}
        dtypes = {p: t.dtype for p, t in leaves(state.params)}
        grads = map_tree(lambda p, g: g.to(dtypes[p]), grads)
        new_state, opt_metrics = opt.apply_updates(state, grads, opt_cfg)
        metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                   for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return new_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """Build ``eval_step(params, batch) -> metrics`` (no gradient)."""
    loss_fn = api.loss_fn(cfg)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics
    return eval_step
