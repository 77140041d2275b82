"""The benchmark's harness: cells resolved by name, the stream pool and
the closed loop around ``PipelinedExecutor.push``, the traced window,
the comparison with the plain reference."""
