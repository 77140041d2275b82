"""Distributed OASRS execution, paper §3.2 "Distributed execution".

Only the ingest contract is ported in this slice: ``local_update`` is the
per-shard chunk fold and performs no collective. The merges across
shards (one all_reduce per query, one all_gather per emission) come with
the sharded placements.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import oasrs


def local_update(state: oasrs.OASRSState, stratum_ids: torch.Tensor,
                 payload: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> oasrs.OASRSState:
    """Per-shard ingestion: just the local chunk fold, no collective."""
    return oasrs.update_chunk(state, stratum_ids, payload, mask)
