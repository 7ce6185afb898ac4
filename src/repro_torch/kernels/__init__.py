"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers, the
plain PyTorch versions (``ref``) and the device dispatch (``ops``).
Nothing is built at import time."""
