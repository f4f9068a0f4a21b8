"""Sorting (the hw2 workload and lab5's sort task).

The reference sorts ascending with a serial bubble sort
(``hw2/src/main.c:4-15``); the JAX package calls ``jnp.sort``
(``tpulab/ops/sortops.py``), and this module gives its order:

* the sort is stable;
* -0.0 and +0.0 compare equal and keep their input order;
* NaNs go last, in their input order, their payloads kept.

``torch.sort(stable=True)`` keeps that order on the CPU but not on the
card, where it is a radix sort over the keys' bits: on an H100 its output
differed from the CPU's for floats holding signed zeros and NaNs of
distinct payloads (``chip_smoke.py`` phase 8b reports it).  So floats are
sorted by a canonical key (every zero +0.0, every NaN the quiet NaN
0x7fc00000) and the input is gathered by the key's stable order: equal
keys keep their input order on either device, and the output holds the
input's own bits.  uint8 is widened to int32 for the sort and narrowed
back, as the JAX package does.  No hand-written kernel: ``jnp.sort`` is
no Pallas kernel either.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpulab_torch.runtime.device import resolve_device


def canonical_keys(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every zero made +0.0 and every NaN the same quiet NaN."""
    keys = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device), x)
    return torch.where(torch.isnan(x), torch.full((), float("nan"), dtype=x.dtype,
                                                  device=x.device), keys)


def sort_ascending(x: torch.Tensor) -> torch.Tensor:
    """Stable ascending sort of a 1-D tensor, in ``jnp.sort``'s order."""
    if x.dtype == torch.uint8:
        return torch.sort(x.to(torch.int32), stable=True).values.to(torch.uint8)
    if not x.dtype.is_floating_point:
        return torch.sort(x, stable=True).values
    order = torch.sort(canonical_keys(x), stable=True).indices
    return torch.take(x, order)


def sort_op(values, *, backend: Optional[str] = None) -> torch.Tensor:
    """Stage ``values`` on the resolved device and sort them."""
    device = resolve_device(backend)
    return sort_ascending(torch.as_tensor(values).to(device))
