"""Elementwise vector ops (the lab1 workload family).

Reference semantics: double-precision elementwise subtraction over vectors
whose values span [-1e100, 1e100] (reference ``lab1/src/main.cu:22-29``).
Every dtype runs on the device it is given, float64 included: the card has
native f64, where the JAX package had to send it to the CPU.  The op
itself is :func:`tpulab_torch.ops.cuda.elementwise.binary`; this module
stages the host vectors.
"""

from __future__ import annotations

import numpy as np
import torch


DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


def stage_vector(values: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    """Host float64 values -> a ``dtype`` tensor on ``device``.

    bfloat16 rounds through float32 first, as the JAX package stages it
    (``tpulab/labs/lab1.py:52-56``), so both see the same inputs.
    """
    if dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; have {sorted(DTYPES)}")
    host = np.asarray(values, np.float64 if dtype == "float64" else np.float32)
    return torch.from_numpy(host).to(device=device, dtype=DTYPES[dtype])

