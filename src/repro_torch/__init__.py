"""PyTorch/CUDA port of StreamApprox's pipelined runtime.

Same module layout as the JAX package ``repro`` (which stays the
reference): ``core`` (OASRS, Eq. 5-9 estimators, the interval ring),
``runtime`` (watermark routing, controller, standing queries, the
pipelined executor), ``kernels`` (hand-written CUDA kernels with their
plain PyTorch versions). Imports torch and numpy only.
"""
