"""lab1 — elementwise vector subtraction over the stdin protocol.

Contract (reference ``lab1/src/to_plot.cu:33-88``): read optional
``grid block`` sweep prefix, then ``n`` and two n-vectors of doubles from
stdin; print the timing line first, then the result as ``%.10e``-formatted
space-separated values.  ``dtype`` is ``float64`` (the reference's
``double``), ``float32`` or ``bfloat16``; every one runs on the device.
"""

from __future__ import annotations

from typing import Optional

from tpulab_torch.io import protocol
from tpulab_torch.ops.cuda.elementwise import binary
from tpulab_torch.ops.elementwise import stage_vector
from tpulab_torch.runtime.device import device_label, resolve_device
from tpulab_torch.runtime.timing import format_timing_line, measure_kernel_ms


def run(
    text: str,
    sweep: bool = False,
    backend: Optional[str] = None,
    *,
    op: str = "subtract",
    dtype: str = "float64",
    warmup: int = 2,
    reps: int = 5,
    **_ignored,
) -> str:
    """Process one stdin payload; returns the full stdout content."""
    inp = protocol.parse_lab1(text, sweep=sweep)
    device = resolve_device(backend)
    a = stage_vector(inp.a, dtype, device)
    b = stage_vector(inp.b, dtype, device)

    def fn(x, y):
        return binary(op, x, y, inp.launch)

    out = fn(a, b)  # the task payload: ONE application
    ms, _ = measure_kernel_ms(fn, (a, b), device=device, iters=max(20 * reps, 40),
                              warmup=warmup)
    payload = protocol.format_vector_10e(out.double().cpu().numpy())
    return format_timing_line(device_label(device), ms) + "\n" + payload
