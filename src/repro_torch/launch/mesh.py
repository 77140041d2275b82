"""Meshes: the production and smoke meshes of the model programs, the
fake process group of the dry-run, the roofline's hardware figures, and
the stream mesh (one process per OASRS shard over ``torch.distributed``).

Counterpart of the reference's ``launch/mesh.py``.
:func:`make_production_mesh` and :func:`make_smoke_mesh` build a
``DeviceMesh`` with the reference's axis names on the default process
group. :func:`fake_group` sets up (and tears down) a group of 256 or 512
ranks that moves no data, for ``launch/dryrun``; nothing is initialized
at import. :class:`Hardware` holds the figures the roofline divides by,
with the H100 SXM5's data-sheet values as :data:`H100_SXM5` and the
reference's TPU v5e constants as :data:`TPU_V5E`.

The reference's ``make_stream_mesh`` builds a 1-D ``(shard,)`` device
mesh in one process. Here each shard is
a process (a rank) of an initialized process group: NCCL with one GPU
per rank on the card, gloo on the CPU. ``RuntimeConfig(placement="mesh")``
executors call :func:`make_stream_mesh`; rank ``r`` holds shard ``r``.
Nothing here starts a process or reads the environment: the caller
initializes the group first, e.g. in each of ``W`` processes::

    torch.distributed.init_process_group(
        "nccl", init_method="tcp://localhost:29500", world_size=W, rank=r)
    ex = PipelinedExecutor(RuntimeConfig(..., num_shards=W,
                                         placement="mesh"),
                           registry, key, device=f"cuda:{r}")
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as tdist

#: The axis the runtime shards over (the reference's mesh axis name).
STREAM_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """This process's place in the stream mesh (the default group)."""
    rank: int                 # the shard this process holds
    num_shards: int


def make_stream_mesh(num_shards: int) -> StreamMesh:
    """The mesh of ``placement="mesh"``: checks that an initialized
    process group has ``num_shards`` ranks, and raises with the recipe
    otherwise (as the reference raises for too few devices)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    recipe = (
        "placement='mesh' runs one process per shard: in each of the "
        f"{num_shards} processes call torch.distributed.init_process_group"
        "(backend ('nccl', one GPU per rank, or 'gloo' on the CPU), "
        f"init_method=..., world_size={num_shards}, rank=r) before "
        "building the executor")
    if not (tdist.is_available() and tdist.is_initialized()):
        raise ValueError(f"no initialized process group; {recipe}")
    world = tdist.get_world_size()
    if world != num_shards:
        raise ValueError(f"the process group has {world} ranks, "
                         f"num_shards is {num_shards}; {recipe}")
    return StreamMesh(rank=tdist.get_rank(), num_shards=num_shards)


# ---------------------------------------------------------------------------
# The model programs' meshes.
# ---------------------------------------------------------------------------

def _device_mesh(shape: tuple, axes: tuple, device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the default group, which must
    have exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for d in shape:
        n *= d
    recipe = (
        f"a {shape} {axes} mesh needs a process group of {n} ranks: call "
        "torch.distributed.init_process_group(backend, init_method=..., "
        f"world_size={n}, rank=r) in each rank first, or use "
        f"launch.mesh.fake_group({n}) for a dry-run")
    if not (tdist.is_available() and tdist.is_initialized()):
        raise ValueError(f"no initialized process group; {recipe}")
    if tdist.get_world_size() != n:
        raise ValueError(f"the process group has {tdist.get_world_size()} "
                         f"ranks; {recipe}")
    return DeviceMesh(device_type, torch.arange(n).view(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``data × model`` or (2, 16, 16) ``pod × data × model``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_smoke_mesh(device_type: str = "cuda"):
    """A one-rank mesh with the production axis names."""
    return _device_mesh((1, 1), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A default process group of ``world_size`` ranks that moves no data
    (``torch.testing``'s fake backend): every collective returns at once,
    this process being ``rank``. Destroyed on exit; refuses to replace a
    group that is already initialized."""
    # The fake backend registers itself when this module is imported.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry-run's fake group would replace it")
    tdist.init_process_group("fake", store=FakeStore(),
                             world_size=world_size, rank=rank)
    try:
        yield
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# Hardware figures of the roofline.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-chip peak rates the roofline terms divide by."""
    name: str
    peak_flops_bf16: float      # dense bf16 FLOP/s
    hbm_bytes_per_s: float      # device-memory bytes/s
    link_bytes_per_s: float     # collective bytes/s leaving one chip


#: H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4
#: at 900 GB/s counted in both directions, i.e. 450 GB/s each way: a ring
#: collective's bytes per device are the bytes it sends, one direction.
H100_SXM5 = Hardware("H100 SXM5", 989e12, 3.35e12, 450e9)

#: The reference's TPU v5e-like constants (per chip; ICI per link).
TPU_V5E = Hardware("TPU v5e", 197e12, 819e9, 50e9)
