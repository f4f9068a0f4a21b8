"""lab2 — Roberts-cross edge detection over the stdin protocol.

Contract (reference ``lab2/src/main.cu:54-126``, ``to_plot.cu``): read an
optional ``bx by gx gy`` sweep prefix, then input/output file paths; load
the binary RGBA image, run the stencil, write the output ``.data`` file;
print the timing line (and ``FINISHED!`` in sweep mode, matching
to_plot.cu:130).
"""

from __future__ import annotations

from typing import Optional

from tpulab_torch.io import load_image, protocol, save_image
from tpulab_torch.ops.roberts import roberts_staged, unpack_rgba
from tpulab_torch.runtime.device import device_label, resolve_device
from tpulab_torch.runtime.timing import format_timing_line, measure_kernel_ms


def run(
    text: str,
    sweep: bool = False,
    backend: Optional[str] = None,
    *,
    warmup: int = 2,
    reps: int = 5,
    **_ignored,
) -> str:
    inp = protocol.parse_lab2(text, sweep=sweep)
    pixels = load_image(inp.input_path)
    device = resolve_device(backend)

    fn, args = roberts_staged(pixels, launch=inp.launch, device=device)
    out = fn(*args)  # the task payload: ONE application
    ms, _ = measure_kernel_ms(fn, args, device=device, iters=max(20 * reps, 40),
                              warmup=warmup)
    save_image(inp.output_path, unpack_rgba(out))

    lines = [format_timing_line(device_label(device), ms)]
    if sweep:
        lines.append("FINISHED!")
    return "\n".join(lines) + "\n"
