"""Kernel B2: a binary elementwise op over two vectors.

Replaces ``tpulab/ops/pallas/elementwise.py::_ew_kernel`` (reached
through ``pallas_binary``).  The CUDA kernel (``csrc/elementwise.cu``)
runs subtract, add, multiply, minimum and maximum in float64, float32 and
bfloat16 as a grid-stride loop over the literal ``(grid, block)`` launch.
It is bound by bytes: two elements read and one written per op.

:func:`binary_plain` is the same function in plain PyTorch.  Subtract,
add and multiply round once in their type (bfloat16 through float32, as
both XLA and PyTorch do).  ``torch.minimum``/``torch.maximum`` differ from
``jnp.minimum``/``jnp.maximum`` on signed zeros and NaN bits, so
minimum and maximum are written as the same choice between operands that
the kernel makes (see ``csrc/elementwise.cu``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpulab_torch.ops.cuda import _build
from tpulab_torch.runtime.fpenv import ensure_nearest

OPS = ("subtract", "add", "multiply", "minimum", "maximum")
DTYPES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}

#: default block when the caller gives no sweep geometry
DEFAULT_BLOCK = 256


def _pick_min(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    neg = torch.signbit(x)
    a, b = torch.where(neg, y, x), torch.where(neg, x, y)
    return torch.where(torch.isnan(a) | (a < b), a, b)


def _pick_max(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    neg = torch.signbit(x)
    a, b = torch.where(neg, x, y), torch.where(neg, y, x)
    return torch.where(torch.isnan(a) | (a > b), a, b)


_PLAIN = {
    "subtract": torch.sub,
    "add": torch.add,
    "multiply": torch.mul,
    "minimum": _pick_min,
    "maximum": _pick_max,
}


def binary_plain(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``a <op> b``, bit-equal to the kernel."""
    return _PLAIN[op](a, b)


def default_launch(n: int) -> Tuple[int, int]:
    """``(grid, block)`` with one thread per element."""
    return min(max(1, -(-n // DEFAULT_BLOCK)), 2**31 - 1), DEFAULT_BLOCK


def binary(
    op: str,
    a: torch.Tensor,
    b: torch.Tensor,
    launch: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``a <op> b`` elementwise for contiguous tensors of one shape and dtype.

    ``launch`` is the reference sweep's ``(grid, block)``, launched as
    given.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel.
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; have {OPS}")
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(
            f"operands differ: {a.dtype} {tuple(a.shape)} on {a.device} vs "
            f"{b.dtype} {tuple(b.shape)} on {b.device}"
        )
    if a.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {a.dtype}; have {list(DTYPES)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("operands must be contiguous")
    grid, block = launch if launch is not None else default_launch(a.numel())
    _build.check_geometry((grid,), (block,))
    if a.device.type == "cpu":
        ensure_nearest()
        return binary_plain(op, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty_like(a)
    lib = _build.load_library()
    rc = lib.tl_binary(
        OPS.index(op), DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
        a.numel(), grid, block, _build.stream_handle(a.device),
    )
    binary.launches += 1
    _build.check_launch(rc, f"elementwise {op} kernel")
    return out


binary.launches = 0
