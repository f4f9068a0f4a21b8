"""lab3 — per-pixel Mahalanobis classification over the stdin protocol.

Contract (reference ``lab3/src/main.cu:78-171``, ``to_plot.cu:75-81``):
optional ``blocks threads`` sweep prefix; input/output paths; ``nc``
classes each given as ``np`` sample-pixel ``(x, y)`` coordinate pairs.
Host computes f64 class statistics, the device kernel writes the argmin
class label into each pixel's alpha channel; output goes to the ``.data``
file; the timing line is printed first.  ``compute_dtype`` is
``float64`` (the reference's ``double``) or ``float32``.
"""

from __future__ import annotations

from typing import Optional

from tpulab_torch.io import load_image, protocol, save_image
from tpulab_torch.ops.mahalanobis import class_statistics, classify_staged
from tpulab_torch.ops.roberts import unpack_rgba
from tpulab_torch.runtime.device import device_label, resolve_device
from tpulab_torch.runtime.timing import format_timing_line, measure_kernel_ms


def run(
    text: str,
    sweep: bool = False,
    backend: Optional[str] = None,
    *,
    compute_dtype: str = "float64",
    warmup: int = 2,
    reps: int = 5,
    **_ignored,
) -> str:
    inp = protocol.parse_lab3(text, sweep=sweep)
    pixels = load_image(inp.input_path)
    # host-side f64 statistics, exactly as the reference's host stage
    stats = class_statistics(pixels, [c.points for c in inp.classes])
    device = resolve_device(backend)

    fn, args = classify_staged(
        pixels, stats, launch=inp.launch, device=device, compute_dtype=compute_dtype
    )
    out = fn(*args)  # the task payload: ONE application
    ms, _ = measure_kernel_ms(fn, args, device=device, iters=max(20 * reps, 40),
                              warmup=warmup)
    save_image(inp.output_path, unpack_rgba(out))
    return format_timing_line(device_label(device), ms) + "\n"
