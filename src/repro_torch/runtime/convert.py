"""Carry runtime state and configuration between the reference and the port.

The reference's ``RuntimeState`` travels as a nested dict of numpy arrays
with the reference's field names::

    {"window": {"intervals": {"values", "counts", "capacity", "key"},
                "cursor", "filled"},
     "slot_interval", "open_interval",
     "wm": {"max_time", "on_time", "late", "dropped"},
     "ctrl": {"capacity", "base_capacity", "latency_ema", "pressure"},
     "metrics": {"ingested", "accepted", "late", "dropped", "replaced",
                 "occupancy", "chunks", "items"}}

A sharded state has the same fields, each leaf with a leading ``[W]``
axis. PRNG keys stay raw u32 words (numpy uint32 on the reference's side,
int64 tensors here). A checkpoint holds the state as a ``RuntimeState``
of numpy arrays (:func:`host_state`), its leaves named and ordered as
the reference's pytree flattens its ``RuntimeState``
(:func:`named_leaves`). Query results travel as a dict of numpy arrays
per query name: ``{"value", "variance"}`` for an estimate, plus ``"keys"``
and ``"sample_weight"`` for heavy hitters. :func:`results_to_numpy`
reads either package's results by their (shared) field names; this
module imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import adaptive, oasrs
from repro_torch.core import window as win
from repro_torch.core.error import Estimate
from repro_torch.core.sketches import HeavyHitters
from repro_torch.obs import metrics as obm
from repro_torch.runtime import controller as ctl
from repro_torch.runtime import watermark as wmk
from repro_torch.runtime.executor import RuntimeConfig, RuntimeState
from repro_torch.utils import DeviceLike, resolve_device

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a, order="C")
    if a.dtype == np.uint32:                        # PRNG key words
        a = a.astype(np.int64)
    elif a.dtype not in _DTYPES:
        raise TypeError(f"unexpected dtype {a.dtype} in reference state")
    # One C-ordered copy into a fresh allocation on ``device`` (0-dim
    # arrays stay 0-dim): the port updates its state in place, never the
    # caller's arrays, and a fresh allocation keeps the address phase of
    # a fresh run.
    return torch.tensor(a, device=device)


def _array(t: torch.Tensor) -> np.ndarray:
    # A copy on every device: on the CPU ``numpy()`` shares the tensor's
    # buffer, which the executors update in place.
    return t.detach().to("cpu", copy=True).numpy()


#: The one leaf of PRNG key words (u32 in a payload, int64 here).
KEY_LEAF = ".window.intervals.key"


def named_leaves(state: RuntimeState) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf of a ``RuntimeState``, named and
    ordered as the reference's ``jax.tree_util.keystr`` paths of its
    ``RuntimeState`` (dataclass fields, depth first), e.g.
    ``.window.intervals.values`` first and ``.metrics.items`` last."""
    out = []

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v, path = getattr(obj, f.name), f"{prefix}.{f.name}"
            if dataclasses.is_dataclass(v):
                walk(v, path)
            else:
                out.append((path, v))
    walk(state, "")
    return out


def map_leaves(state: RuntimeState,
               fn: Callable[[str, Any], Any]) -> RuntimeState:
    """The state rebuilt with ``fn(path, leaf)`` in place of each leaf."""
    def walk(obj, prefix):
        kw = {}
        for f in dataclasses.fields(obj):
            v, path = getattr(obj, f.name), f"{prefix}.{f.name}"
            kw[f.name] = (walk(v, path) if dataclasses.is_dataclass(v)
                          else fn(path, v))
        return type(obj)(**kw)
    return walk(state, "")


def payload_dtype(path: str, t: torch.Tensor) -> np.dtype:
    """The numpy dtype of the leaf ``path`` (holding ``t`` here) in the
    reference's state and in a payload: key words as u32, every other
    leaf as f32, i32 or bool."""
    if path == KEY_LEAF:
        return np.dtype(np.uint32)
    return next(n for n, tt in _DTYPES.items() if tt == t.dtype)


def host_state(state: RuntimeState) -> RuntimeState:
    """A numpy copy of every leaf (:func:`payload_dtype`); on the card
    the copies wait for the work queued on the state."""
    return map_leaves(state, lambda p, t: _array(t).astype(
        payload_dtype(p, t), copy=False))


def device_state(state: RuntimeState, device: DeviceLike = None
                 ) -> RuntimeState:
    """The inverse of :func:`host_state`: every leaf in a fresh
    allocation of its own on ``device``."""
    dev = resolve_device(device)
    return map_leaves(state, lambda _, a: _tensor(a, dev))


def state_from_numpy(d: Dict[str, Any],
                     device: DeviceLike = None) -> RuntimeState:
    """The port's :class:`RuntimeState` from the reference's, as a dict."""
    dev = resolve_device(device)

    def conv(cls, sub):
        return cls(**{f.name: _tensor(sub[f.name], dev)
                      for f in dataclasses.fields(cls)})

    w = d["window"]
    return RuntimeState(
        window=win.WindowState(
            intervals=conv(oasrs.OASRSState, w["intervals"]),
            cursor=_tensor(w["cursor"], dev),
            filled=_tensor(w["filled"], dev)),
        slot_interval=_tensor(d["slot_interval"], dev),
        open_interval=_tensor(d["open_interval"], dev),
        wm=conv(wmk.WatermarkState, d["wm"]),
        ctrl=conv(ctl.ControllerState, d["ctrl"]),
        metrics=conv(obm.MetricsState, d["metrics"]))


def state_to_numpy(state: RuntimeState) -> Dict[str, Any]:
    """The inverse of :func:`state_from_numpy`."""
    out: Dict[str, Any] = {}
    for path, a in named_leaves(host_state(state)):
        *parents, name = path.split(".")[1:]
        d = out
        for p in parents:
            d = d.setdefault(p, {})
        d[name] = a
    return out


def config_from_dict(d: Dict[str, Any]) -> RuntimeConfig:
    """:class:`RuntimeConfig` field by field from the reference's fields
    (``controller`` and its ``budget`` as nested dicts of numbers)."""
    d = dict(d)
    c = dict(d.pop("controller", None) or {})
    budget = c.pop("budget", None)
    if budget is not None:
        budget = adaptive.BudgetConfig(
            target_half_width=float(np.asarray(budget["target_half_width"])),
            z=float(np.asarray(budget["z"])),
            min_per_stratum=int(np.asarray(budget["min_per_stratum"])),
            max_per_stratum=int(np.asarray(budget["max_per_stratum"])))
    return RuntimeConfig(controller=ctl.ControllerConfig(budget=budget, **c),
                         **d)


def config_to_dict(cfg: RuntimeConfig) -> Dict[str, Any]:
    """The inverse of :func:`config_from_dict`."""
    return dataclasses.asdict(cfg)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.array(x)


def results_to_numpy(results: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """One emission's answers as numpy, from the port's results or the
    reference's (an estimate has ``value``/``variance``; heavy hitters
    add ``keys``, ``estimate`` and ``sample_weight``)."""
    out = {}
    for name, r in results.items():
        if hasattr(r, "estimate"):
            out[name] = {"keys": _np(r.keys),
                         "value": _np(r.estimate.value),
                         "variance": _np(r.estimate.variance),
                         "sample_weight": _np(r.sample_weight)}
        else:
            out[name] = {"value": _np(r.value), "variance": _np(r.variance)}
    return out


def results_from_numpy(d: Dict[str, Dict[str, Any]],
                       device: DeviceLike = None) -> Dict[str, Any]:
    """The inverse of :func:`results_to_numpy`: the port's
    :class:`Estimate` / :class:`HeavyHitters` on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name, r in d.items():
        est = Estimate(value=_tensor(r["value"], dev),
                       variance=_tensor(r["variance"], dev))
        out[name] = (HeavyHitters(keys=_tensor(r["keys"], dev),
                                  estimate=est,
                                  sample_weight=_tensor(r["sample_weight"],
                                                        dev))
                     if "keys" in r else est)
    return out
