"""The stream mesh: one process per OASRS shard over ``torch.distributed``.

Counterpart of the reference's ``launch/mesh.make_stream_mesh``, which
builds a 1-D ``(shard,)`` device mesh in one process. Here each shard is
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

import dataclasses

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
