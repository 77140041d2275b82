"""AdamW with f32 master weights, updated in place.

Counterpart of the reference's ``train/optimizer.py`` on one card: the
same ``OptConfig``, ``TrainState`` and arithmetic (the clip scale cast to
the grad's dtype before the multiply; ``c1``/``c2`` from ``b ** step`` in
f32, XLA's CPU ``pow``; the update ``lr·(delta + wd·base)``; the new
master cast to the param's dtype). ``torch.optim.AdamW`` orders the decay
differently and is not the counterpart.

The update runs IN PLACE, leaf by leaf and in slices of a leaf, with at
most two f32 temporaries of one slice alive: at phi4-mini-3.8b's width
the state alone is 66.3 GiB of the card's 79.6, and a functional update
of its largest leaf (805 M elements) would need 3 GiB per temporary.
``apply_updates`` consumes the grads: each leaf is dropped from the tree
once its update is done.

The ZeRO shardings (``zero_pspec``, ``state_shardings``) wait for the
port of ``distributed/sharding`` (ROADMAP item 12d); ``init_state`` takes
``mesh=None`` only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models.param import (leaves, map_tree, params_from_reference,
                                      params_to_reference)
from repro_torch.utils import DeviceLike, resolve_device

#: Elements of one leaf updated at a time (two f32 temporaries of this
#: many elements are alive during the update).
UPDATE_SLICE = 1 << 25


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    use_master: bool = True          # fp32 master copy (bf16 params)
    zero_axes: tuple = ("pod", "data")


@dataclasses.dataclass
class TrainState:
    params: Any        # compute dtype
    master: Any        # f32 (0-dim f32 zeros per leaf if disabled)
    mu: Any            # f32 first moment
    nu: Any            # f32 second moment
    step: torch.Tensor  # 0-dim int32


def _f32(x: float) -> float:
    return float(np.float32(x))


def init_state(params: dict, mesh: Optional[Any], opt_cfg: OptConfig,
               skeleton: Optional[dict] = None) -> TrainState:
    """The state of step 0: an f32 master copy of the params (fresh
    tensors), zero moments, step 0. ``skeleton`` only places the state on
    a mesh in the reference; on one card it changes nothing."""
    if mesh is not None:
        raise NotImplementedError(
            "init_state on a mesh (the ZeRO shardings) waits for ROADMAP "
            "item 12d; pass mesh=None")
    master = map_tree(lambda _p, x: x.to(torch.float32, copy=True), params)
    if not opt_cfg.use_master:
        master = map_tree(lambda _p, x: torch.zeros(
            (), dtype=torch.float32, device=x.device), params)
    zeros = map_tree(lambda _p, x: torch.zeros(
        x.shape, dtype=torch.float32, device=x.device), params)
    dev = next(leaves(params))[1].device
    return TrainState(
        params=params, master=master, mu=zeros,
        nu=map_tree(lambda _p, x: torch.zeros_like(x), zeros),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_at(opt_cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, f32."""
    warm = torch.clamp(step.to(torch.float32)
                       / float(max(opt_cfg.warmup_steps, 1)), max=1.0)
    return _f32(opt_cfg.lr) * warm


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    for a in range(0, flat.numel(), UPDATE_SLICE):
        yield flat[a:a + UPDATE_SLICE]


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every grad IN PLACE by ``min(1, max_norm / |g|)``, the scale
    cast to the grad's dtype first; returns ``(grads, |g|)``. The squares
    are summed per leaf in f32 (in slices: no f32 copy of a leaf), the
    leaves in the reference's flattening order."""
    total = None
    for _, g in leaves(grads):
        s = None
        for c in _slices(g):
            part = torch.sum(torch.square(c.to(torch.float32)))
            s = part if s is None else s + part
        total = s if total is None else total + s
    # f64 then f32: a correctly rounded root, as XLA's.
    gn = torch.sqrt(total.double()).float()
    scale = torch.clamp(_f32(max_norm) / torch.clamp(gn, min=1e-9),
                        max=1.0)
    for _, g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _drop(tree: dict, path: str) -> None:
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree[k]
    del tree[keys[-1]]


def apply_updates(state: TrainState, grads: dict, opt_cfg: OptConfig
                  ) -> tuple[TrainState, dict]:
    """One AdamW step IN PLACE. Grads in the params' dtype; the update
    math in f32. The returned state shares every tensor with ``state``
    but ``step``; ``grads`` is clipped in place and emptied leaf by leaf
    as the update consumes it."""
    grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(opt_cfg, step)
    sf = step.to(torch.float32)
    c1 = 1.0 - prng.xla_pow(torch.full_like(sf, _f32(opt_cfg.b1)), sf)
    c2 = 1.0 - prng.xla_pow(torch.full_like(sf, _f32(opt_cfg.b2)), sf)
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    eps, wd = _f32(opt_cfg.eps), opt_cfg.weight_decay
    paths = [p for p, _ in leaves(grads)]
    for path, g, mu, nu, master, p in zip(
            paths, (t for _, t in leaves(grads)),
            (t for _, t in leaves(state.mu)),
            (t for _, t in leaves(state.nu)),
            (t for _, t in leaves(state.master)),
            (t for _, t in leaves(state.params))):
        parts = zip(_slices(g), _slices(mu), _slices(nu), _slices(p),
                    _slices(master) if opt_cfg.use_master
                    else (None for _ in _slices(p)))
        for g_s, mu_s, nu_s, p_s, m_s in parts:
            t = g_s.to(torch.float32)
            mu_s.mul_(b1).add_(t, alpha=1 - b1)
            nu_s.mul_(b2).addcmul_(t, t, value=1 - b2)
            torch.div(nu_s, c2, out=t).sqrt_().add_(eps)
            delta = torch.div(mu_s, c1).div_(t)
            base = m_s if m_s is not None else p_s.to(torch.float32)
            delta.add_(base, alpha=wd).mul_(lr)
            if m_s is not None:
                m_s.sub_(delta)
                p_s.copy_(m_s)
            else:
                p_s.copy_(base - delta)
        _drop(grads, path)
    new_state = TrainState(params=state.params, master=state.master,
                           mu=state.mu, nu=state.nu, step=step)
    return new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# State carried between the packages.
# ---------------------------------------------------------------------------

def train_state_from_reference(state: Any,
                               device: DeviceLike = None) -> TrainState:
    """The reference's ``TrainState`` (or a dict of its fields), its
    leaves numpy or JAX arrays, as the port's: the same trees and bits.
    On the card unless ``device`` says otherwise."""
    get = (state.get if isinstance(state, dict)
           else lambda k: getattr(state, k))
    dev = resolve_device(device)
    return TrainState(
        params=params_from_reference(get("params"), dev),
        master=params_from_reference(get("master"), dev),
        mu=params_from_reference(get("mu"), dev),
        nu=params_from_reference(get("nu"), dev),
        step=torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32,
                          device=dev))


def train_state_to_reference(state: TrainState) -> dict:
    """The port's state as a dict of the reference's ``TrainState``
    fields, numpy leaves (bf16 as ``ml_dtypes.bfloat16``):
    ``repro.train.optimizer.TrainState(**d)``."""
    return {"params": params_to_reference(state.params),
            "master": params_to_reference(state.master),
            "mu": params_to_reference(state.mu),
            "nu": params_to_reference(state.nu),
            "step": np.asarray(int(state.step), np.int32)}
