"""Observability: device counters folded inside the ingest."""
