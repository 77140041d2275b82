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

On a mesh (the reference's ZeRO shardings: :func:`zero_pspec`,
:func:`state_shardings`, :func:`init_state` with a mesh) the params are
``DTensor`` s placed by their logical axes and the f32 master and moments
are also split over the data axes. :func:`apply_updates` then brings each
grad to its moments' placement (a reduce-scatter where the grad is a
pending sum), updates every rank's shards in place, and gathers the new
params back to their own placement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.distributed import sharding as shd
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


def zero_pspec(pspec: tuple, shape: tuple, mesh, zero_axes: tuple) -> tuple:
    """Fold the DP axes into the first divisible unsharded dim of
    ``pspec`` (the reference's ``zero_pspec``; specs as tuples)."""
    if mesh is None:
        return pspec
    sizes = shd.axis_sizes(mesh)
    free = [a for a in zero_axes if a in sizes]
    if not free:
        return pspec
    dp = int(np.prod([sizes[a] for a in free]))
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (cur, dim) in enumerate(zip(parts, shape)):
        if cur is None and dim % dp == 0:
            parts[i] = tuple(free) if len(free) > 1 else free[0]
            return tuple(parts)
    return pspec  # nothing divisible: stay param-sharded


def state_shardings(skeleton: dict, mesh, opt_cfg: OptConfig) -> TrainState:
    """A :class:`TrainState` of ``sharding.NamedSharding`` s: params by
    their logical axes, master and moments ZeRO-split, step replicated
    (None everywhere without a mesh)."""
    def pshard(_p, s):
        return shd.named_sharding(s.logical, s.shape, mesh)

    def zshard(_p, s):
        if mesh is None:
            return None
        base = shd.resolve_spec(s.logical, s.shape, mesh)
        return shd.NamedSharding(
            mesh, zero_pspec(base, s.shape, mesh, opt_cfg.zero_axes))

    zero = map_tree(zshard, skeleton)
    scalar = shd.NamedSharding(mesh, ()) if mesh is not None else None
    return TrainState(params=map_tree(pshard, skeleton), master=zero,
                      mu=zero, nu=zero, step=scalar)


def init_state(params: dict, mesh, opt_cfg: OptConfig,
               skeleton: Optional[dict] = None) -> TrainState:
    """The state of step 0: an f32 master copy of the params (fresh
    tensors), zero moments, step 0. On a mesh the master and moments are
    ``DTensor`` s ZeRO-split from each leaf's spec (from ``skeleton``'s
    logical axes, or replicated without one, as the reference)."""
    def master_of(path, x):
        x32 = x.to(torch.float32, copy=True)
        if mesh is None:
            return x32
        sk = skel.get(path)
        base = (shd.resolve_spec(sk.logical, sk.shape, mesh) if sk
                else (None,) * x.dim())
        want = shd.NamedSharding(mesh, zero_pspec(base, tuple(x.shape), mesh,
                                                  opt_cfg.zero_axes))
        if isinstance(x32, shd.DTensor):
            return x32.redistribute(mesh, want.placements)
        return shd.distribute(x32, want)

    skel = dict(leaves(skeleton)) if skeleton is not None else {}
    master = map_tree(master_of, params)
    zeros = map_tree(lambda _p, x: torch.zeros_like(x), master)
    if not opt_cfg.use_master:
        master = map_tree(lambda _p, x: torch.zeros(
            (), dtype=torch.float32, device=x.device), params)
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
    if isinstance(t, shd.DTensor):
        # a rank's shards are small: whole, and no flattening of a
        # sharded dim
        yield t
        return
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
    """Delete the leaf at ``path`` from its dict (a list part of the path
    is an index; every leaf's own container is a dict)."""
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    del tree[keys[-1]]


def apply_updates(state: TrainState, grads: dict, opt_cfg: OptConfig
                  ) -> tuple[TrainState, dict]:
    """One AdamW step IN PLACE. Grads in the params' dtype; the update
    math in f32. The returned state shares every tensor with ``state``
    but ``step``; ``grads`` is clipped in place and emptied leaf by leaf
    as the update consumes it."""
    if isinstance(next(leaves(state.mu))[1], shd.DTensor):
        # ZeRO: each grad to its moments' placement before the norm.
        zp = {p: t.placements for p, t in leaves(state.mu)}
        grads = map_tree(lambda p, g: g.redistribute(g.device_mesh, zp[p]),
                         grads)
    grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(opt_cfg, step)
    sf = step.to(torch.float32)
    if isinstance(sf, shd.DTensor):
        # a [1] copy: xla_pow's table lookups must not take a 0-dim index
        # (a host read of the step)
        sf = sf.to_local().reshape(1)
    c1 = 1.0 - prng.xla_pow(torch.full_like(sf, _f32(opt_cfg.b1)), sf)
    c2 = 1.0 - prng.xla_pow(torch.full_like(sf, _f32(opt_cfg.b2)), sf)
    paths = [p for p, _ in leaves(grads)]
    scalars = None                 # lr, c1, c2 on this rank, on a mesh
    for path, g, mu, nu, master, p in zip(
            paths, (t for _, t in leaves(grads)),
            (t for _, t in leaves(state.mu)),
            (t for _, t in leaves(state.nu)),
            (t for _, t in leaves(state.master)),
            (t for _, t in leaves(state.params))):
        if isinstance(p, shd.DTensor):
            if scalars is None:
                scalars = tuple(_local(t).reshape(()) for t in (lr, c1, c2))
            _update_shards(g, mu, nu, master, p, opt_cfg, *scalars)
            _drop(grads, path)
            continue
        parts = zip(_slices(g), _slices(mu), _slices(nu), _slices(p),
                    _slices(master) if opt_cfg.use_master
                    else (None for _ in _slices(p)))
        for g_s, mu_s, nu_s, p_s, m_s in parts:
            base = m_s if m_s is not None else p_s.to(torch.float32)
            delta = _adamw(g_s.to(torch.float32), mu_s, nu_s, base, opt_cfg,
                           lr, c1, c2)
            if m_s is not None:
                m_s.sub_(delta)
                p_s.copy_(m_s)
            else:
                p_s.copy_(base - delta)
        _drop(grads, path)
    new_state = TrainState(params=state.params, master=state.master,
                           mu=state.mu, nu=state.nu, step=step)
    return new_state, {"grad_norm": gnorm, "lr": lr}


def _local(t):
    return t.to_local() if isinstance(t, shd.DTensor) else t


def _adamw(t, mu_s, nu_s, base, opt_cfg: OptConfig, lr, c1, c2):
    """The AdamW arithmetic of one slice, IN PLACE: ``t`` is the slice's
    f32 grad (overwritten), the moments ``mu_s`` / ``nu_s`` are updated,
    and the step ``lr·(delta + wd·base)`` is returned (the new value is
    ``base`` less it)."""
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    mu_s.mul_(b1).add_(t, alpha=1 - b1)
    nu_s.mul_(b2).addcmul_(t, t, value=1 - b2)
    torch.div(nu_s, c2, out=t).sqrt_().add_(_f32(opt_cfg.eps))
    delta = torch.div(mu_s, c1).div_(t)
    return delta.add_(base, alpha=opt_cfg.weight_decay).mul_(lr)


def _update_shards(g, mu, nu, master, p, opt_cfg: OptConfig, lr, c1, c2):
    """One leaf's AdamW step on a mesh: :func:`_adamw` on this rank's
    shards of the grad (already at the moments' placement), moments and
    master; the new param, cast in the moments' placement, gathered to
    the param's own placement."""
    mesh = mu.device_mesh
    zp = mu.placements
    if opt_cfg.use_master:
        base = master.to_local()
    else:
        base = p.redistribute(mesh, zp).to_local().to(torch.float32)
    delta = _adamw(_local(g).to(torch.float32), mu.to_local(), nu.to_local(),
                   base, opt_cfg, lr, c1, c2)
    new = base.sub_(delta) if opt_cfg.use_master else base - delta
    new_p = shd.DTensor.from_local(new.to(p.dtype), mesh, zp,
                                   run_check=False, shape=p.shape,
                                   stride=p.stride())
    p.copy_(new_p.redistribute(mesh, p.placements))


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
