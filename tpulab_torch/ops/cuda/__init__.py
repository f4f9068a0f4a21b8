"""Hand-written CUDA kernels for Hopper, one module per kernel.

Each module holds the kernel's wrapper (which launches the kernel from
``tpulab_torch/csrc/`` for a CUDA tensor), the same function in plain
PyTorch (which the wrapper runs for a CPU tensor), and a launch counter on
the wrapper.  The counterpart of ``tpulab.ops.pallas``.
"""
