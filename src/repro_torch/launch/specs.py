"""Abstract inputs and programs of every dry-run cell.

Counterpart of the reference's ``launch/specs.py``. ``input_specs(arch,
shape)`` returns ``meta`` tensors (nothing allocated) of the reference's
shapes and dtypes for every input of the cell's program, and
``build_program`` pairs them with the function the cell runs and the
placement of every argument on a ``DeviceMesh``:

  train_4k     → ``train_step``  (OASRS-weighted loss + AdamW/ZeRO update)
  prefill_32k  → ``prefill``     (prompt forward + cache build)
  decode_32k   → ``decode``      (one new token against a seq_len cache)
  long_500k    → ``decode``      (sub-quadratic archs only)

Arguments are trees of tensors: a ``TrainState`` or a ``KVCache`` (dense,
moe, vlm serving state) field by field, dicts and lists (the params, the
encdec, hybrid and ssm states); :func:`tree_map` maps over them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import configs as cfgs
from repro_torch.distributed import sharding as shd
from repro_torch.models import api
from repro_torch.models import kvcache as kvc
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import abstract_params, map_tree, param_shardings
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class CellProgram:
    """Everything needed to run one dry-run cell."""
    name: str
    fn: Callable
    args: tuple              # meta tensors (trees), global shapes
    in_shardings: Any        # the same trees of sharding.NamedSharding
    mode: str                # train | prefill | decode


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def tree_map(fn: Callable, tree, *others):
    """``fn(leaf, *other leaves)`` over a tree of tensors (and trees of the
    same structure): dataclasses (``TrainState``, ``KVCache``) field by
    field, dicts, lists and tuples; other leaves (None, numbers) kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *others)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name),
                          (torch.Tensor, dict, list, tuple))
            or dataclasses.is_dataclass(getattr(tree, f.name))})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return tree


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def batch_specs(cfg: ModelConfig, seq_len: int, batch: int) -> dict:
    """Abstract training (or prefill) batch of one step."""
    specs = {
        "tokens": _meta((batch, seq_len), torch.int32),
        "weights": _meta((batch,), torch.float32),
    }
    if cfg.family == "encdec":
        specs["frames"] = _meta((batch, seq_len, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        specs["tokens"] = _meta((batch, seq_len - cfg.num_patches),
                                torch.int32)
        specs["patches"] = _meta((batch, cfg.num_patches, cfg.d_model),
                                 cfg.dtype)
    return specs


def decode_state_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """The abstract zero decode state at ``seq_len`` (``meta`` tensors,
    built outside any mesh)."""
    with shd.use_mesh(None):
        return api.init_decode_state(cfg, batch, seq_len, device="meta")


def input_specs(arch: str, shape: str,
                cfg: Optional[ModelConfig] = None) -> dict:
    """The abstract inputs of the cell's program."""
    cfg = cfg or cfgs.get_config(arch)
    seq_len, batch = cfgs.SHAPES[shape]
    if shape == "train_4k" or shape.startswith("prefill"):
        return batch_specs(cfg, seq_len, batch)
    return {"tokens": _meta((batch, 1), torch.int32),
            "state": decode_state_specs(cfg, batch, seq_len)}


def _batch_shardings(specs: dict, mesh) -> dict:
    return {k: shd.NamedSharding(mesh, shd.resolve_spec(
        ["batch"] + [None] * (v.dim() - 1), v.shape, mesh))
        for k, v in specs.items()}


def _state_leaf_sharding(leaf: torch.Tensor, batch: int, mesh):
    """Serve-state placement. 5-D leaves are KV caches ``[L, B, S, Hkv,
    hd]``: full logical resolution (batch over DP, flash-decode seq / head
    sharding over model per the active rules). Other leaves: the first dim
    equal to ``batch`` goes data-parallel; the rest replicate."""
    if leaf.dim() == 5:
        return shd.NamedSharding(mesh, shd.resolve_spec(
            kvc.CACHE_LOGICAL, leaf.shape, mesh))
    parts = [None] * leaf.dim()
    for i, d in enumerate(leaf.shape):
        if d == batch:
            parts[i] = shd.resolve_spec(("batch",), (d,), mesh)[0]
            break
    return shd.NamedSharding(mesh, tuple(parts))


def serve_state_shardings(state_abstract, batch: int, mesh):
    return tree_map(lambda t: _state_leaf_sharding(t, batch, mesh),
                    state_abstract)


def abstract_train_state(cfg: ModelConfig, skeleton: dict) -> opt.TrainState:
    params = abstract_params(skeleton)
    f32 = map_tree(lambda _p, t: _meta(t.shape, torch.float32), params)
    return opt.TrainState(
        params=params, master=f32, mu=f32,
        nu=map_tree(lambda _p, t: _meta(t.shape, torch.float32), params),
        step=_meta((), torch.int32))


def _zero_axes(cfg: ModelConfig) -> tuple:
    return (("pod", "data", "model") if getattr(cfg, "pure_dp", False)
            else ("pod", "data"))


def build_program(arch: str, shape: str, mesh,
                  cfg_override: Optional[ModelConfig] = None,
                  opt_cfg: Optional[opt.OptConfig] = None) -> CellProgram:
    cfg = cfg_override or cfgs.get_config(arch)
    seq_len, batch = cfgs.SHAPES[shape]
    if opt_cfg is None:
        opt_cfg = opt.OptConfig(zero_axes=_zero_axes(cfg))
    skeleton = api.skeleton(cfg)
    name = f"{arch}:{shape}"

    with shd.use_mesh(mesh, shd.build_rules(cfg, mesh)):
        p_shard = param_shardings(skeleton, mesh)
        if shape == "train_4k":
            specs = batch_specs(cfg, seq_len, batch)
            st_shard = opt.state_shardings(skeleton, mesh, opt_cfg)
            return CellProgram(
                name=name, fn=make_train_step(cfg, opt_cfg),
                args=(abstract_train_state(cfg, skeleton), specs),
                in_shardings=(st_shard, _batch_shardings(specs, mesh)),
                mode="train")

        if shape.startswith("prefill"):
            specs = batch_specs(cfg, seq_len, batch)
            pf = api.prefill_fn(cfg)
            return CellProgram(
                name=name, fn=lambda params, b: pf(params, b),
                args=(abstract_params(skeleton), specs),
                in_shardings=(p_shard, _batch_shardings(specs, mesh)),
                mode="prefill")

        state_abs = decode_state_specs(cfg, batch, seq_len)
        tok = _meta((batch, 1), torch.int32)
        dec = api.decode_fn(cfg)
        st_shard = serve_state_shardings(state_abs, batch, mesh)
        tok_shard = shd.NamedSharding(
            mesh, shd.resolve_spec(("batch", None), tok.shape, mesh))
        return CellProgram(
            name=name, fn=lambda params, state, tokens: dec(params, state,
                                                            tokens),
            args=(abstract_params(skeleton), state_abs, tok),
            in_shardings=(p_shard, st_shard, tok_shard), mode="decode")
