"""Logical-axis sharding rules (MaxText-style) for the production mesh.

Counterpart of the reference's ``distributed/sharding.py``. Model code
annotates tensors with *logical* axis names; a rules table maps them to
named mesh dimensions at launch time, so one model definition runs on the
(data=16, model=16) mesh, the multi-pod (pod=2, data=16, model=16) one,
or no mesh at all.

Divisibility-aware: a logical axis is mapped only when the tensor dim is
divisible by the mesh-axis size (llama3-405B's 8 KV heads cannot shard
over model=16 and stay replicated), decided per tensor at annotation
time.

Spec resolution needs only axis names and sizes: :func:`resolve_spec`
takes a ``torch.distributed.device_mesh.DeviceMesh`` or any object whose
``.shape`` maps axis names to sizes (:class:`AbstractMesh`, or the
reference's ``jax.sharding.AbstractMesh``), and returns the reference's
``PartitionSpec`` as a tuple, entry for entry. :func:`placements` turns
such a spec into ``DTensor`` placements, one per mesh dimension: a tensor
dim over ``("pod", "data")`` is ``Shard(d)`` on both mesh dimensions, in
mesh order (the reference's major-to-minor split when, as in every rule
here, the tuple lists the axes in mesh order).

Without an active mesh :func:`shard` returns its argument before any
torch call, so the model paths of one card are unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

Logical = Union[str, None, tuple]
#: A resolved spec: per tensor dim ``None``, one axis name or a tuple.
Spec = Tuple[Union[str, None, Tuple[str, ...]], ...]


def _rules(*pairs) -> dict:
    """Build a rules table, refusing duplicate logical-axis names (a dict
    literal silently keeps only the last duplicate key)."""
    out: dict = {}
    for name, phys in pairs:
        if name in out:
            raise ValueError(f"duplicate sharding rule {name!r}")
        out[name] = phys
    return out


#: Default logical → physical rules. Order matters for tuples: the first
#: mesh axis that divides the dim wins (others appended if they also fit).
DEFAULT_RULES: dict = _rules(
    ("batch", ("pod", "data")),     # DP over pods × data
    ("seq", None),                  # sequence kept local by default
    ("seq_sp", "model"),            # sequence parallelism (opt-in)
    ("embed", None),                # activations: d_model replicated
    # Weights' d_model dim is never model-sharded (that would be
    # contracting-dim sharding, one activation-sized reduction per
    # matmul); Megatron pattern instead: column-parallel in-projections,
    # row-parallel out-projections, one reduction per block.
    ("embed_tp", None),
    ("q_heads", "model"),           # TP over attention heads
    ("kv_heads", "model"),          # TP over KV heads (when divisible)
    ("q_group", "model"),           # TP over the GQA group dim (fallback 1)
    ("head_dim_tp", None),          # reserved (feature-sharded attention)
    ("attn_seq", None),             # sequence-parallel attention (fallback 2)
    ("kv_seq", None),               # KV-cache sequence axis; build_rules
                                    # flips it to "model" (flash-decode
                                    # cache sharding) in TP modes 2/3
    ("seq_res", None),              # Megatron-SP residual stream (opt-in)
    ("head_dim", None),
    ("mlp", "model"),               # TP over FFN hidden
    ("vocab", "model"),             # TP over vocab (embeds + logits)
    ("experts", "model"),           # EP over experts
    ("expert_mlp", None),           # within-expert hidden
    ("moe_group", ("pod", "data", "model")),  # dispatch groups
    ("layers", None),               # stacked-layer axis: never sharded
    ("rnn", "model"),               # recurrent width (RG-LRU, xLSTM)
    ("frames", None),               # audio/vision frontend positions
    ("stack", None),
)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only (``shape``: name → size), for resolving
    specs without a process group."""
    shape: Mapping[str, int]


def axis_sizes(mesh) -> Dict[str, int]:
    """``name → size`` of a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``) or of any mesh whose ``.shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


class _Ctx:
    """The active mesh and rules. Process-wide, not per thread (the
    reference's is thread-local): on the card autograd runs the backward,
    and with it the recomputation of each checkpointed layer, in a device
    thread of its own, which must take the same branches."""

    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)
        self.card_products = False


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh and rules for the model annotations."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES) if rules is None else dict(rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


@contextlib.contextmanager
def local_region():
    """Inside, code runs on one rank's shards: :func:`shard` is a no-op
    (the rules stay active for :func:`get_rule`)."""
    with use_mesh(None, _CTX.rules):
        yield


def active_mesh():
    return _CTX.mesh


@contextlib.contextmanager
def card_products():
    """Inside, :func:`f32_out_products` holds on every device. The
    dry-run enters it around its fake tensors, which compute nothing, so
    that what it counts is the card's program."""
    prev = _CTX.card_products
    _CTX.card_products = True
    try:
        yield
    finally:
        _CTX.card_products = prev


def f32_out_products(device: torch.device) -> bool:
    """Whether products on ``device`` take f32 results from low-precision
    operands directly (cuBLAS's ``mm(..., out_dtype=)``): on the card, or
    inside :func:`card_products`."""
    return device.type == "cuda" or _CTX.card_products


def build_rules(cfg, mesh) -> dict:
    """Pick the attention TP mode for one arch × mesh, as the reference.

    Exactly one of {kv_heads, q_group, attn_seq} maps to ``model``:
      1. ``kv_heads`` divisible by TP: Megatron head sharding;
      2. the GQA group ``G = Hq/Hkv`` divisible: shard Q's group dim, KV
         replicated;
      3. otherwise sequence-parallel attention: Q's sequence axis over
         ``model``, K/V replicated, one query block
         (``models/attention.chunked_causal_attention``).
    Decode: the KV cache's sequence axis shards over ``model`` in modes
    2/3 (flash-decode), the head axis in mode 1. ``pure_dp`` drops tensor
    parallelism; ``sp_residual`` shards the residual stream's sequence;
    MoE shards experts over ``model`` when their count divides, else the
    within-expert hidden dim.
    """
    rules = dict(DEFAULT_RULES)
    sizes = axis_sizes(mesh) if mesh is not None else {}
    if "model" not in sizes:
        return rules
    if getattr(cfg, "pure_dp", False):
        for k in ("embed_tp", "q_heads", "kv_heads", "q_group",
                  "head_dim_tp", "attn_seq", "mlp", "vocab", "experts",
                  "expert_mlp", "rnn", "kv_seq", "seq_res"):
            rules[k] = None
        rules["batch"] = ("pod", "data", "model")
        rules["moe_group"] = ("pod", "data", "model")
        return rules
    tp = sizes["model"]
    hkv = max(cfg.num_kv_heads, 1)
    g = max(cfg.num_heads // hkv, 1)
    rules["kv_heads"] = None
    rules["q_group"] = None
    rules["attn_seq"] = None
    if hkv % tp == 0:
        rules["kv_heads"] = "model"
        rules["kv_seq"] = None
    elif g % tp == 0:
        rules["q_group"] = "model"
        rules["kv_seq"] = "model"
    else:
        rules["attn_seq"] = "model"
        rules["kv_seq"] = "model"
    if getattr(cfg, "sp_residual", False):
        rules["seq_res"] = "model"
    if getattr(cfg, "num_experts", 0):
        if cfg.num_experts % tp == 0:
            rules["experts"] = "model"
            rules["expert_mlp"] = None
        else:
            rules["experts"] = None
            rules["expert_mlp"] = "model"
    return rules


def get_rule(name: str):
    """The active physical mapping of one logical axis (None if inactive)."""
    return _CTX.rules.get(name)


def resolve_spec(logical: Sequence[Logical], shape: Sequence[int],
                 mesh=None, rules: Optional[dict] = None) -> Spec:
    """Map logical axis names to a spec (the reference's ``PartitionSpec``
    as a tuple), dropping non-divisible or unavailable mesh axes per
    dim."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return (None,) * len(logical)
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for name, dim in zip(logical, shape):
        phys = rules.get(name) if name is not None else None
        if phys is None:
            out.append(None)
            continue
        cand = phys if isinstance(phys, tuple) else (phys,)
        picked = []
        size = 1
        for ax in cand:
            if ax in used or ax not in sizes:
                continue
            if dim % (size * sizes[ax]) == 0:
                picked.append(ax)
                size *= sizes[ax]
        if picked:
            used.update(picked)
            out.append(tuple(picked) if len(picked) > 1 else picked[0])
        else:
            out.append(None)
    return tuple(out)


def placements(spec: Spec, mesh) -> tuple:
    """``DTensor`` placements of a spec on ``mesh``: per mesh dimension
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                owner[ax] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in mesh.mesh_dim_names)


def local_shape(spec: Spec, shape: Sequence[int], mesh) -> tuple:
    """One rank's shard shape of a tensor of ``shape`` under ``spec``
    (every mapped dim divides evenly, as :func:`resolve_spec` keeps)."""
    sizes = axis_sizes(mesh)
    out = []
    for entry, dim in zip(spec, shape):
        axes = entry if isinstance(entry, tuple) else (entry,)
        out.append(dim // math.prod(sizes[a] for a in axes if a is not None))
    return tuple(out) + tuple(shape[len(spec):])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def local_shape_and_offset(x: DTensor) -> tuple:
    """This rank's shard shape of ``x`` and the global index of its first
    element, per dim (``torch.chunk``'s split over each sharded mesh dim
    in mesh order; Python arithmetic only, no torch op)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    shape, offset = list(x.shape), [0] * x.dim()
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            d, n = pl.dim, mesh.size(i)
            size = -(-shape[d] // n)
            start = min(coord[i] * size, shape[d])
            offset[d] += start
            shape[d] = min(size, shape[d] - start)
    return tuple(shape), tuple(offset)


def named_sharding(logical: Sequence[Logical], shape: Sequence[int],
                   mesh=None) -> Optional[NamedSharding]:
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve_spec(logical, shape, mesh))


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x``, the same value on every rank, as a ``DTensor`` placed by
    ``sharding``: each rank keeps its own shard (no communication)."""
    from torch.distributed.tensor import Replicate
    full = DTensor.from_local(x, sharding.mesh,
                              [Replicate()] * sharding.mesh.ndim,
                              run_check=False)
    return full.redistribute(sharding.mesh, sharding.placements)


def from_local(local: torch.Tensor, shape: Sequence[int], mesh,
               placements_: Sequence) -> DTensor:
    """A ``DTensor`` of global ``shape`` (contiguous) from this rank's
    shard, with ``placements_`` on ``mesh``."""
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh, tuple(placements_),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def zeros(shape: Sequence[int], logical: Sequence[Logical],
          dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.zeros(shape)``, placed by the logical axes under a mesh:
    each rank allocates only its shard."""
    mesh = _CTX.mesh
    if mesh is None:
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    sh = NamedSharding(mesh, resolve_spec(logical, shape, mesh))
    local = torch.zeros(local_shape(sh.spec, shape, mesh), dtype=dtype,
                        device=device)
    return from_local(local, shape, mesh, sh.placements)


def local(x: DTensor, out: Sequence) -> torch.Tensor:
    """``x``'s shard, for a computation on this rank's shards whose result
    is placed by ``out`` (one placement per mesh dim). Where ``x`` is
    replicated over a mesh dim but the result is not, each rank used ``x``
    for its own part of the work, so the shard's gradient is a pending sum
    over that dim."""
    from torch.distributed.tensor import Partial, Replicate
    grad = tuple(Partial() if isinstance(p, Replicate)
                 and not isinstance(o, Replicate) else p
                 for p, o in zip(x.placements, out))
    return x.to_local(grad_placements=grad)


class _Reduce(torch.autograd.Function):
    """An all-reduce over mesh dims whose result every rank then uses as
    one replicated value: the gradient reaching each rank is already the
    whole gradient of every input shard, and passes through unchanged."""

    @staticmethod
    def forward(ctx, t, op, mesh, dims):
        from torch.distributed import _functional_collectives as funcol
        for d in dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def all_reduce(t: torch.Tensor, op: str, mesh, dims: Sequence[int]
               ) -> torch.Tensor:
    """``t`` (a rank's local tensor) reduced with ``op`` (``"sum"``,
    ``"max"``) over the mesh dims ``dims``, for use as a replicated
    value (differentiable: see :class:`_Reduce`)."""
    if not dims:
        return t
    return _Reduce.apply(t, op, mesh, tuple(dims))


def shard(x: torch.Tensor, *logical: Logical) -> torch.Tensor:
    """Place ``x`` by logical names (the reference's
    ``with_sharding_constraint``): a ``DTensor`` is redistributed to the
    resolved placements, a plain tensor (the same value on every rank)
    cut to this rank's shard. No-op without a mesh."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    sh = NamedSharding(mesh, resolve_spec(logical, x.shape, mesh))
    if not isinstance(x, DTensor):
        return distribute(x, sh)
    want = sh.placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_product(x, w, tail: tuple, fn):
    """``fn(x's shard, w's shard)`` for x ``[B, S, ..., D]`` times w ``[D,
    ...]`` placed by its logical axes, each rank multiplying its own
    shards: x keeps its batch dim's sharding, is sharded on its last dim
    where w is sharded on dim 0 (the contracted dim) and replicated
    elsewhere. The result ``[B, S, *tail]`` is a ``DTensor`` sharded on
    its batch dim like x, on dim ``2 + j`` where w is sharded on dim ``j
    + 1`` (its head dims), and a pending sum where w is sharded on dim
    0."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = w.device_mesh
    want, out = [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim == 0:
            want.append(xp)
            out.append(xp)
        elif isinstance(wp, Shard) and wp.dim == 0:
            want.append(Shard(x.dim() - 1))
            out.append(Partial())
        else:
            want.append(Replicate())
            out.append(Shard(wp.dim + 1) if isinstance(wp, Shard)
                       else Replicate())
    x = x.redistribute(mesh, want)
    y = fn(local(x, out), local(w, out))
    shape = tuple(x.shape[:2]) + tuple(tail)
    return from_local(y, shape, mesh, out)


def on_batch_shards(fn, batch: int, *ts, whole: Sequence = ()):
    """``fn(b0, *ts, *whole)`` on this rank's rows of a computation that is
    independent per row of dim 0 (batch rows, dispatch groups). Without
    ``DTensor`` arguments, ``fn(0, *ts, *whole)``. Otherwise each
    ``DTensor`` of ``ts`` is placed with dim 0 over the batch axes and the
    rest replicated, ``fn`` gets the local shards (other arguments as they
    are), the index ``b0`` of the first local row and each tensor of
    ``whole`` (weights) gathered in full, and each of its outputs is the
    shard of a ``DTensor`` of leading dim ``batch`` placed alike. A weight's
    gradient is a pending sum over the mesh dims that split the batch."""
    if not any(isinstance(t, DTensor) for t in ts):
        return fn(0, *ts, *whole)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ts = [shard(t, "batch", *([None] * (t.dim() - 1)))
          if isinstance(t, DTensor) else t for t in ts]
    first = next(t for t in ts if isinstance(t, DTensor))
    mesh = first.device_mesh
    b0 = local_shape_and_offset(first)[1][0]
    split = [Partial() if isinstance(p, Shard) else Replicate()
             for p in first.placements]
    full = [w.full_tensor(grad_placements=split)
            if isinstance(w, DTensor) else w for w in whole]
    with local_region():
        outs = fn(b0, *(t.to_local() if isinstance(t, DTensor) else t
                        for t in ts), *full)

    def wrap(o):
        shape = (batch,) + tuple(o.shape[1:])
        spec = resolve_spec(("batch",) + (None,) * (o.dim() - 1), shape,
                            mesh)
        return from_local(o, shape, mesh, placements(spec, mesh))
    return tuple(map(wrap, outs)) if isinstance(outs, tuple) else wrap(outs)
