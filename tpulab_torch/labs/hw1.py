"""hw1 — quadratic-equation solver over the stdin protocol.

Contract (reference ``hw1/src/main.c:4-35``): read ``a b c`` floats, print
the roots as ``%.6f`` (or ``any``/``incorrect``/``imaginary``).  The
reference prints no timing line; pass ``--timing`` to prepend one (the
harness-driven extension).  The reference and the JAX package solve the
one equation on the host, so the timing word is ``CPU`` whatever the
backend: that is the workload itself, not a fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpulab_torch.io import protocol
from tpulab_torch.ops.quadratic import solve_scalar
from tpulab_torch.runtime.device import resolve_device
from tpulab_torch.runtime.timing import format_timing_line, measure_kernel_ms


def run(
    text: str,
    sweep: bool = False,
    backend: Optional[str] = None,
    *,
    timing: bool = False,
    warmup: int = 0,
    reps: int = 1,
    **_ignored,
) -> str:
    resolve_device(backend)  # an unknown backend, or no card without a cpu request, fails here
    a, b, c = protocol.parse_hw1(text)
    if timing:
        ms, line = measure_kernel_ms(solve_scalar, (a, b, c), device=torch.device("cpu"),
                                     iters=reps, warmup=warmup)
        return format_timing_line("CPU", ms) + "\n" + line + "\n"
    return solve_scalar(a, b, c) + "\n"
