"""Quadratic-equation solving (the hw1 workload).

Scalar semantics follow the reference bit for bit in float32 (reference
``hw1/src/main.c:4-35``): degenerate cases ``any`` (0=0), ``incorrect``
(0x+0=c), linear root ``-c/b``; discriminant ``D = b*b - 4*a*c`` with
two/one/zero (``imaginary``) real roots.  :func:`solve_scalar` is the JAX
package's numpy function, unchanged.  :func:`solve_batch` is its batched
generalization (``tpulab/ops/quadratic.py:45-77``, a ``jax.jit``) as
tensor ops on the resolved device, with the same status codes and NaN in
unused root slots.

The discriminant is ``b*b - (4a)·c`` rounded at each step and its square
root is correctly rounded, as in the reference's C and in
:func:`solve_scalar`.  The JAX package's compiled ``solve_batch`` rounds
the discriminant otherwise: XLA:CPU contracts it into fused multiply-adds,
differently for the statuses and for each root, and differently again in
the scalar remainder at the end of a thread's chunk of rows (ROADMAP C8),
so its roots lie within one rounding of the discriminant of these, and
equal them bit for bit where the discriminant is exact.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def solve_scalar(a: float, b: float, c: float) -> str:
    """Solve one equation; returns the exact stdout line of the reference."""
    a = np.float32(a)
    b = np.float32(b)
    c = np.float32(c)
    if a == 0:
        if b == 0:
            return "any" if c == 0 else "incorrect"
        root = np.float32(-c) / b
        return f"{root:.6f}"
    d = b * b - np.float32(4) * a * c
    if d > 0:
        sq = np.float32(np.sqrt(d))
        r1 = (-b + sq) / (np.float32(2) * a)
        r2 = (-b - sq) / (np.float32(2) * a)
        return f"{r1:.6f} {r2:.6f}"
    if d == 0:
        return f"{-b / (np.float32(2) * a):.6f}"
    return "imaginary"


# status codes for the batched solver
TWO_ROOTS, ONE_ROOT, NO_REAL, ANY, INCORRECT = 0, 1, 2, 3, 4


def solve_batch(coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched f32 solver: (n, 3) coefficients -> (status (n,), roots (n, 2)).

    Runs on the device ``coeffs`` lies on.
    """
    coeffs = coeffs.to(torch.float32)
    a, b, c = coeffs[:, 0], coeffs[:, 1], coeffs[:, 2]
    d = b * b - 4.0 * a * c
    # a float32 sqrt through float64 is correctly rounded; torch's float32
    # sqrt on the CPU is not (it is off by an ulp on ~0.7% of inputs)
    sq = torch.sqrt(torch.clamp(d, min=0.0).double()).float()
    two_a = 2.0 * a
    r1 = (-b + sq) / two_a
    r2 = (-b - sq) / two_a
    lin = -c / b
    nan = torch.full_like(a, float("nan"))

    cases = [
        ((a == 0) & (b == 0) & (c == 0), ANY),
        ((a == 0) & (b == 0), INCORRECT),
        (a == 0, ONE_ROOT),
        (d > 0, TWO_ROOTS),
        (d == 0, ONE_ROOT),
    ]
    status = torch.full(a.shape, NO_REAL, dtype=torch.int64, device=a.device)
    for cond, code in reversed(cases):  # the first true condition wins
        status = torch.where(cond, code, status)
    root1 = torch.where((a != 0) & (d >= 0), r1, nan)
    root1 = torch.where((a == 0) & (b != 0), lin, root1)
    root2 = torch.where((a != 0) & (d > 0), r2, nan)
    return status, torch.stack([root1, root2], dim=1)
