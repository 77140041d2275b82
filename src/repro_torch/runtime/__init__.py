"""Streaming runtime: records, watermarks, controller, standing queries,
the executors, checkpoint and restore, and state conversion from the
reference."""
from repro_torch.runtime.checkpoint import Checkpointer, RuntimeCheckpoint

__all__ = ["Checkpointer", "RuntimeCheckpoint"]
