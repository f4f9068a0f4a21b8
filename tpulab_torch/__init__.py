"""tpulab_torch — the lab framework on PyTorch and CUDA, for NVIDIA Hopper.

The port of :mod:`tpulab` (JAX on a TPU) to an H100.  The JAX package
stays the reference: each part here is held against its counterpart there
on the same inputs.  This package never imports JAX or ``tpulab``.

* Pallas TPU kernels          -> hand-written CUDA C++ kernels for sm_90a
                                 (``csrc/``, built by ``nvcc`` at first use)
* TPU tile remaps of a sweep  -> the literal CUDA ``(grid, block)`` launch
* f64 routed to the CPU       -> f64 on the card
* chained-loop TPU timing     -> the reference's CUDA-event bracket

Layout (mirroring ``tpulab``):
    tpulab_torch.io         binary/hex/png image codecs, stdin protocol grammars
    tpulab_torch.ops        compute ops (roberts, elementwise, mahalanobis)
    tpulab_torch.ops.cuda   kernel wrappers, each beside its plain PyTorch version
    tpulab_torch.labs       per-workload stdin/stdout entry points (lab1..lab3)
    tpulab_torch.runtime    device selection, introspection, timing
    tpulab_torch.utils      CLI config coercion
    tpulab_torch.cli        ``python -m tpulab_torch``

Entry points run on the CUDA card unless the caller asks for the CPU
(``--backend cpu``); with no card they raise.
"""

from tpulab_torch.runtime.device import device_info, resolve_device
from tpulab_torch.runtime.timing import format_timing_line, measure_kernel_ms

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "device_info",
    "format_timing_line",
    "measure_kernel_ms",
    "resolve_device",
]
