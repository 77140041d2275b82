"""Batched serving with StreamApprox telemetry (``serve_step.Server``)."""
