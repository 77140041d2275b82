"""PyTorch/CUDA port of StreamApprox's pipelined runtime.

Same module layout as the JAX package ``repro`` (which stays the
reference): ``core`` (OASRS, Eq. 5-9 estimators, the interval ring),
``runtime`` (watermark routing, controller, standing queries, the
pipelined executor), ``kernels`` (hand-written CUDA kernels with their
plain PyTorch versions), ``stream`` (the reference's sources and
replayable streams), ``obs`` (telemetry, event log, retrace sentinel),
``configs`` and ``models`` (the architectures' configs and the dense
serving path), ``serve`` (batched serving with StreamApprox telemetry)
and ``launch`` (the stream mesh, the serving CLI). Imports torch and
numpy only.
"""
