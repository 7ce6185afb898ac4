"""repro_torch: the EdgeAI-Hub serving stack ported to PyTorch and CUDA
for an NVIDIA H100.

A second package beside the JAX reference ``repro``: every module here
has a counterpart of the same name there, does the same job under the
same contract, and never imports JAX or ``repro``.  Each TPU kernel on
a ported path becomes a kernel written by hand for Hopper
(``csrc/``, built at first use by ``kernels.build``) with a plain
PyTorch version beside it in ``kernels.ref``.  Entry points run on the
card unless the caller passes ``device="cpu"``.

Ported so far: configs, the weight bridge, the dense family's paged
serving path and dense decode cache (``models``), int8 projection
weights, the paged engine with speculative decoding (``serving``) and
the drain CLI (``python -m repro_torch.launch.serve``).  See ROADMAP.md
for the queue.
"""
