"""hw2 — ascending float sort over the stdin protocol.

Contract (reference ``hw2/src/main.c:17-42``): read ``n`` then n floats,
print the sorted values as ``%.6e`` space-separated plus newline.  The
reference prints no timing line; ``--timing`` prepends one.  The sort
runs on the resolved device (:func:`tpulab_torch.ops.sortops.sort_ascending`).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpulab_torch.io import protocol
from tpulab_torch.ops.sortops import sort_ascending
from tpulab_torch.runtime.device import device_label, resolve_device
from tpulab_torch.runtime.timing import format_timing_line, measure_kernel_ms


def run(
    text: str,
    sweep: bool = False,
    backend: Optional[str] = None,
    *,
    timing: bool = False,
    warmup: int = 2,
    reps: int = 5,
    **_ignored,
) -> str:
    values = protocol.parse_hw2(text)
    device = resolve_device(backend)
    # staged before the bracket; every timed call sorts the unsorted x again
    x = torch.from_numpy(values.astype("float32")).to(device)
    if timing:
        ms, out = measure_kernel_ms(sort_ascending, (x,), device=device, iters=max(reps, 5),
                                    warmup=warmup)
        prefix = format_timing_line(device_label(device), ms) + "\n"
    else:
        out = sort_ascending(x)
        prefix = ""
    return prefix + protocol.format_vector_6e(out.cpu().numpy())
