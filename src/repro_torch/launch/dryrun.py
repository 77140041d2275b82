"""Multi-pod dry-run: run every (arch × shape × mesh) cell on fake tensors.

Counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for a forced 512-device host mesh. Here the cell runs
eagerly, once, as one rank of a fake process group of 256 or 512 ranks
(``launch.mesh.fake_group``: collectives move no data): its parameters
and inputs are ``DTensor`` s over fake tensors (``FakeTensorMode``: no
memory is allocated), placed by the logical-axis rules
(``distributed/sharding``) on the (16, 16) or (2, 16, 16) ``DeviceMesh``.
:class:`Counter` watches the rank's own (local) ops and reads back what
the reference reads from XLA:

* memory per device: argument bytes are the sum of the rank's shard
  bytes; output bytes the shard bytes of every output tensor (aliases
  of an argument included, as XLA counts outputs without donation);
  ``temp_bytes`` is the peak of the bytes held by storages that the
  run's ops allocated, each storage counted from the op that created it
  until it is freed (arguments excluded, outputs included while alive);
* FLOPs per device: ``torch.utils.flop_counter``'s formulas on each local
  op (a ``DTensor`` op is counted by the local ops it runs, not at its
  global shape);
* bytes per device: input plus output bytes of every local op that
  returns a tensor and is not a view (eager ops are not fused, so this
  exceeds XLA's figure);
* collectives per kind: the functional collectives the run issued, with
  the reference's ring multipliers (all-reduce 2x its result,
  reduce-scatter its input, the others their result). There is no
  partitioned HLO to parse: ``DTensor`` issues each redistribution as a
  ``_c10d_functional`` op on the local shard, which the counter sees.

``trace_sec`` (the run's wall time) takes the place of the reference's
``lower_sec`` / ``compile_sec``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
      --shape train_4k [--multi-pod] [--out results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as cfgs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import (CellProgram, build_program,
                                      tree_leaves, tree_map)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
#: ``_c10d_functional`` op name prefix → (kind, bytes counted from)
_FUNCOL = (("all_reduce", "all-reduce", "out2"),
           ("all_gather", "all-gather", "out"),
           ("reduce_scatter", "reduce-scatter", "in"),
           ("all_to_all", "all-to-all", "out"),
           ("broadcast", "collective-permute", "out"))


#: Ops that move no data although their schema returns a fresh tensor.
_NO_DATA = {"aten::_unsafe_view", "aten::lift_fresh", "aten::detach"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: Where ``DTensor``'s sharding propagation lives: it runs each op once at
#: its global shape on fake tensors (to learn the output's shape), and
#: those calls are no rank's work. :class:`Counter` refuses to count if
#: torch has moved it (the global-shape calls would then be counted).
_PROPAGATION = os.path.join("tensor", "_sharding_prop.py")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class Counter(TorchDispatchMode):
    """Counts one rank's local ops: FLOPs, bytes, collectives, live
    memory. Ops on ``DTensor`` s are passed on (``NotImplemented``) so
    that the ops their dispatch runs on the local shards are the ones
    counted."""

    def __init__(self, arguments=(), loopback: bool = False):
        super().__init__()
        from torch.distributed.tensor import _sharding_prop
        if not _sharding_prop.__file__.endswith(_PROPAGATION):
            raise RuntimeError(f"DTensor's sharding propagation is not in "
                               f"{_PROPAGATION}: {_sharding_prop.__file__}")
        self.loopback = loopback
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.coll_bytes = {k: 0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._held = {}
        self._external = {id(t.untyped_storage()) for t in arguments}

    def _free(self, key: int, n: int) -> None:
        self._held.pop(key, None)
        self.live -= n

    def _track(self, outs) -> None:
        for t in _tensors(outs):
            st = t.untyped_storage()
            key = id(st)
            if key in self._held or key in self._external:
                continue
            n = st.nbytes()
            self._held[key] = weakref.finalize(st, self._free, key, n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, shd.DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        self.ops += 1
        self._track(out)
        name = func.name()
        if name.startswith("_c10d_functional::"):
            op = name.split("::", 1)[1]
            for prefix, kind, source in _FUNCOL:
                if op.startswith(prefix):
                    n = sum(map(_nbytes, _tensors(
                        args[0] if source == "in" else out)))
                    self.coll_bytes[kind] += 2 * n if source == "out2" else n
                    self.coll_counts[kind] += 1
                    if self.loopback:
                        _loop_back(op, args, out)
                    break
            return out
        formula = self.flop_registry.get(func._overloadpacket)
        if formula is not None:
            # the f32-output products (mm.dtype, bmm.dtype) end in a dtype
            fargs = args[:-1] if func._overloadname == "dtype" else args
            self.flops += formula(*fargs, **kwargs, out_val=out)
        outs = _tensors(out)
        if outs and name not in _NO_DATA and not any(
                r.alias_info is not None for r in func._schema.returns):
            self.bytes += sum(map(_nbytes, _tensors(list(args)
                                                    + list(kwargs.values())
                                                    + outs)))
        return out


def _loop_back(op: str, args, out) -> None:
    """Fill a collective's output as if every rank held this rank's input
    (the fake group leaves a gather's or a scatter's output unwritten):
    a gather repeats the input, a reduce-scatter keeps its first chunk, an
    all-to-all its input. All-reduces are in place and keep the input."""
    if not isinstance(out, torch.Tensor) or op.startswith("all_reduce"):
        return
    src = args[0]
    if op.startswith("all_gather"):
        out.copy_(src.repeat((out.shape[0] // src.shape[0],)
                             + (1,) * (src.dim() - 1)))
    elif op.startswith("reduce_scatter"):
        out.copy_(src[:out.shape[0]])
    elif op.startswith("all_to_all"):
        out.copy_(src)


# ---------------------------------------------------------------------------
# Arguments and outputs.
# ---------------------------------------------------------------------------

def local_bytes(tree) -> int:
    """The rank's bytes of every tensor of ``tree``."""
    return sum(_nbytes(t.to_local() if isinstance(t, shd.DTensor) else t)
               for t in tree_leaves(tree))


def place(abstract, sharding, make_local: Callable):
    """A ``DTensor`` of ``abstract``'s global shape and dtype placed by
    ``sharding``, its local shard ``make_local(shape, dtype)``."""
    shape = shd.local_shape(sharding.spec, tuple(abstract.shape),
                            sharding.mesh)
    return shd.from_local(make_local(shape, abstract.dtype),
                          tuple(abstract.shape), sharding.mesh,
                          sharding.placements)


def program_inputs(prog: CellProgram, make_local: Callable) -> tuple:
    """The program's arguments as ``DTensor`` s (``make_local`` builds each
    rank shard)."""
    return tuple(tree_map(lambda a, s: place(a, s, make_local), arg, sh)
                 for arg, sh in zip(prog.args, prog.in_shardings))


@contextlib.contextmanager
def _mode(prog: CellProgram):
    """Serving runs without autograd; the train step takes its own."""
    if prog.mode == "train":
        yield
    else:
        with torch.no_grad():
            yield


def run_program(prog: CellProgram, args: tuple, cfg,
                loopback: bool = False) -> tuple:
    """``prog.fn(*args)`` under the program's mesh and rules, counted;
    returns ``(outputs, counter, seconds)``. ``loopback``: real tensors on
    a fake group, each collective's output filled from this rank's input
    (:func:`_loop_back`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = tree_leaves_shardings(prog.in_shardings)[0].mesh
    counter = Counter([t.to_local() for t in tree_leaves(args)
                       if isinstance(t, shd.DTensor)], loopback)
    t0 = time.perf_counter()
    from torch._subclasses.fake_tensor import is_fake
    fake = any(is_fake(t.to_local()) for t in tree_leaves(args)
               if isinstance(t, shd.DTensor))
    # fake tensors: the card's f32-output products (a torch whose fake
    # tensors lack ``mm(..., out_dtype=)`` fails here)
    products = shd.card_products() if fake else contextlib.nullcontext()
    with shd.use_mesh(mesh, shd.build_rules(cfg, mesh)), \
            implicit_replication(), _mode(prog), products, counter:
        out = prog.fn(*args)
    return out, counter, time.perf_counter() - t0


def tree_leaves_shardings(tree) -> list:
    """The ``NamedSharding`` leaves of a tree of them."""
    if isinstance(tree, shd.NamedSharding):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [s for f in dataclasses.fields(tree)
                for s in tree_leaves_shardings(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in tree_leaves_shardings(v)]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in tree_leaves_shardings(v)]
    return []


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             cfg_override=None, verbose: bool = True) -> dict:
    """Run one cell on fake tensors; return the dry-run record."""
    ok, reason = cfgs.cell_applicable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "SKIP",
                "reason": reason}
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg_override or cfgs.get_config(arch)
    world = 512 if multi_pod else 256
    with mesh_lib.fake_group(world):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        prog = build_program(arch, shape, mesh, cfg_override=cfg_override)
        with FakeTensorMode():
            args = program_inputs(prog, lambda s, dt: torch.empty(
                s, dtype=dt))
            out, c, sec = run_program(prog, args, cfg)
            rec = record(arch, shape, multi_pod, prog, args, out, c, sec)
    if verbose:
        mem = rec["memory"]
        print(f"[dryrun] {arch} × {shape} × {rec['mesh']}: OK "
              f"(trace {sec:.1f}s, {c.ops:,} local ops)")
        print(f"  memory: args={mem['argument_bytes']:,} "
              f"out={mem['output_bytes']:,} "
              f"temp={mem['temp_bytes']:,} bytes/device")
        print(f"  flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_per_device']:.3e}")
        print(f"  collectives/dev: {rec['collective_bytes_per_device']:,} "
              f"bytes {rec['collective_counts']}")
    return rec


def record(arch, shape, multi_pod, prog, args, out, c: Counter,
           sec: float) -> dict:
    return {
        "arch": arch, "shape": shape, "mode": prog.mode,
        "mesh": mesh_name(multi_pod), "status": "OK",
        "trace_sec": round(sec, 1),
        "local_ops": c.ops,
        "flops_per_device": c.flops,
        "bytes_per_device": c.bytes,
        "collective_bytes_per_device": sum(c.coll_bytes.values()),
        "collectives": dict(c.coll_bytes),
        "collective_counts": dict(c.coll_counts),
        "memory": {
            "argument_bytes": local_bytes(args),
            "output_bytes": local_bytes(out),
            "temp_bytes": c.peak,
            "alias_bytes": 0,
        },
    }


def _run_or_fail(arch: str, shape: str, multi_pod: bool) -> dict:
    try:
        return run_cell(arch, shape, multi_pod=multi_pod)
    except Exception as e:  # a failure here is a fault of the port
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "status": "FAIL",
                "mesh": mesh_name(multi_pod),
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(cfgs.ARCHS))
    ap.add_argument("--shape", choices=list(cfgs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in cfgs.ARCHS for s in cfgs.SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    recs = (_run_or_fail(a, s, args.multi_pod) for a, s in cells)
    failures = 0
    for rec in recs:
        failures += rec["status"] == "FAIL"
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
