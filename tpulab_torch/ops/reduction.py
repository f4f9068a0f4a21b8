"""Reductions (the lab5 workload family).

The lab5 source was never committed to the reference (only its
``lab5/data`` fixtures exist); the JAX package's documented choice is a
sum / min / max / prod reduction over the typed binary arrays
(``tpulab/ops/reduction.py``), and this module gives its answers:

* integers narrower than 64 bits are widened to **int64** before they are
  reduced, always: the JAX package turns on x64 when it is imported
  (``tpulab/__init__.py:30-39``), so its ``_reduce`` widens to int64 and
  sums and products wrap at 64 bits;
* float32 is reduced in float32 (sums in another order than XLA's, so a
  float32 sum agrees within a tolerance, not bit for bit);
* NaN propagates through min and max;
* min and max order -0.0 below +0.0, as XLA does: the min of {0.0, -0.0}
  is -0.0 in either order and the max is +0.0.  ``torch.amin`` and
  ``torch.amax`` return whichever zero they met first, so a zero result
  takes its sign from whether the input holds the other zero.

No hand-written kernel: the JAX package reduces with ``jnp.sum`` and its
kin outside any Pallas kernel, and PyTorch's reductions serve here.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpulab_torch.runtime.device import resolve_device

REDUCERS = ("sum", "min", "max", "prod")
_NARROW_INTS = (torch.uint8, torch.int8, torch.int16, torch.int32)


def reduce_values(x: torch.Tensor, op: str) -> torch.Tensor:
    """Reduce ``x`` (on whatever device it lies) to a 0-d tensor."""
    if op not in REDUCERS:
        raise ValueError(f"unknown reduction {op!r}; have {sorted(REDUCERS)}")
    if x.dtype in _NARROW_INTS:
        x = x.to(torch.int64)
    if op == "sum":
        return torch.sum(x)
    if op == "prod":
        return torch.prod(x)
    out = torch.amin(x) if op == "min" else torch.amax(x)
    if not x.dtype.is_floating_point:
        return out
    # Where the answer is a zero, no element is negative (min) or positive
    # (max), nor NaN; so the min is -0.0 iff some sign bit is set, and the
    # max is -0.0 iff every sign bit is set.
    sign = torch.signbit(x)
    negative = torch.any(sign) if op == "min" else torch.all(sign)
    zero = torch.where(negative, -0.0, 0.0).to(x.dtype)
    return torch.where(out == 0, zero, out)


def reduce_op(values, op: str = "sum", *, backend: Optional[str] = None) -> torch.Tensor:
    """Stage ``values`` on the resolved device and reduce them."""
    device = resolve_device(backend)
    x = torch.as_tensor(values).to(device)
    return reduce_values(x, op)
