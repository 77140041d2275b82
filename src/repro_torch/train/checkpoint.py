"""Training checkpoints: atomic save/restore, async writes.

Counterpart of the reference's ``train/checkpoint.py``, in its layout, so
a checkpoint written by either package restores in the other:
``<dir>/step_<N:08d>/`` holds one ``leaf_<i:05d>.npy`` per leaf (the
leaf's bytes as a flat ``uint8`` array) and ``manifest.json`` (``step``,
``num_leaves``, ``treedef``, and per leaf its dtype string, bfloat16
included, and shape). A ``COMMIT`` marker written last, inside a
``.tmp`` directory renamed into place, makes a save atomic:
:func:`latest_step` ignores a half-written one.

Leaves are numbered in the order of the reference's
``jax.tree_util.tree_flatten``: dict keys sorted, a ``TrainState``'s
fields in order (params, master, mu, nu, step), an ``OASRSState``'s in
order (values, counts, capacity, key; the key as its two ``uint32``
words). The reference's ``shardings`` (re-placing on another mesh) wait
for ROADMAP item 12d.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.oasrs import OASRSState
from repro_torch.train.optimizer import TrainState

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool, "int16": torch.int16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree: Any, key: bool = False) -> List[Tuple[Any, bool]]:
    """``(leaf, is_prng_key)`` in ``jax.tree_util.tree_flatten``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (TrainState, OASRSState)):
        return [x for f in dataclasses.fields(tree)
                for x in _flatten(getattr(tree, f.name),
                                  key=isinstance(tree, OASRSState)
                                  and f.name == "key")]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    return [(tree, key)]


def _unflatten(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _unflatten(tree[k], it)
        return {k: out[k] for k in tree}
    if isinstance(tree, (TrainState, OASRSState)):
        return type(tree)(**{f.name: _unflatten(getattr(tree, f.name), it)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, it) for t in tree)
    return next(it)


def _host_leaf(leaf: Any, key: bool) -> Tuple[np.ndarray, str, list]:
    """``(flat uint8 bytes, dtype string, shape)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if key:
            arr, name = t.numpy().astype(np.uint32), "uint32"
        elif t.dtype == torch.bfloat16:
            arr, name = t.view(torch.int16).numpy(), "bfloat16"
        else:
            arr, name = t.numpy(), _NAMES[t.dtype]
    else:
        arr = np.asarray(leaf)
        arr = arr.astype(np.uint32) if key else arr
        name = str(arr.dtype)
    shape = list(arr.shape)
    return (np.ascontiguousarray(arr).reshape(-1).view(np.uint8), name,
            shape)


def host_leaves(tree: Any) -> list:
    """Every leaf of ``tree`` copied to the host, in the file's form."""
    return [_host_leaf(leaf, key) for leaf, key in _flatten(tree)]


def _write(directory: str, step: int, host: list, keep_last: int) -> str:
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = ckpt_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    manifest = {"step": step, "num_leaves": len(host),
                "treedef": f"repro_torch tree of {len(host)} leaves",
                "leaves": []}
    for i, (raw, name, shape) in enumerate(host):
        manifest["leaves"].append({"dtype": name, "shape": shape})
        np.save(os.path.join(tmp_dir, f"leaf_{i:05d}.npy"), raw)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.rename(tmp_dir, ckpt_dir)
    _gc(directory, keep_last)
    return ckpt_dir


def save(directory: str, step: int, tree: Any, keep_last: int = 3) -> str:
    """Synchronous atomic checkpoint save; returns the step's directory."""
    return _write(directory, step, host_leaves(tree), keep_last)


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training.

    ``save`` copies the leaves to the host (blocking only on the copy),
    then writes in a background thread. ``wait`` joins the write in
    flight (call before exit or before another save).
    """

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any):
        self.wait()
        host = host_leaves(tree)
        self._thread = threading.Thread(
            target=_write, args=(self.directory, step, host,
                                 self.keep_last))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMIT")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _leaf_tensor(raw: np.ndarray, meta: dict, key: bool,
                 device) -> torch.Tensor:
    name, shape = meta["dtype"], meta["shape"]
    if name == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(shape).copy()
                                ).view(torch.bfloat16).to(device)
    arr = raw.view(np.dtype(name)).reshape(shape)
    if key or name == "uint32":
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


def restore(directory: str, step: int, target: Any,
            shardings: Any = None) -> Any:
    """Restore into ``target``'s structure: each leaf a fresh tensor on
    its target leaf's device (the CPU for a leaf that is not a tensor),
    in the file's dtype (a PRNG key's ``uint32`` words as int64)."""
    if shardings is not None:
        raise NotImplementedError(
            "restore onto a mesh waits for ROADMAP item 12d")
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(target)
    if manifest["num_leaves"] != len(flat):
        raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                         f"target {len(flat)}")
    out = []
    for i, (leaf, key) in enumerate(flat):
        raw = np.load(os.path.join(ckpt_dir, f"leaf_{i:05d}.npy"))
        meta = manifest["leaves"][i]
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if tuple(meta["shape"]) != shape:
            raise ValueError(f"leaf {i}: checkpoint shape "
                             f"{tuple(meta['shape'])} != target {shape}")
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out.append(_leaf_tensor(raw, meta, key, dev))
    return _unflatten(target, iter(out))


def _gc(directory: str, keep_last: int):
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(directory, n, "COMMIT")))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
