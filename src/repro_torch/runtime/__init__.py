"""Streaming runtime: records, watermarks, controller, standing queries,
the pipelined executor, and state conversion from the reference."""
