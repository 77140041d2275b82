"""Hand-written CUDA kernels (``csrc/``), their wrappers, their plain
PyTorch versions (``ref.py``) and the device dispatch (``ops.py``)."""
