"""Roberts-cross edge detection (the lab2 workload).

Semantics (reference ``lab2/src/main.cu:15-52`` and the CPU twin
``lab2/src/main.c:14-59``):

* neighbor fetches at ``(x+1, y)``/``(x, y+1)``/``(x+1, y+1)`` with
  **clamp** addressing at the image border,
* f32 luminance from the weights 0.299, 0.587, 0.114,
* gradients ``Gx = Y11 - Y00``, ``Gy = Y10 - Y01``,
* magnitude ``sqrt(Gx^2 + Gy^2)`` clamped to [0, 255] and **truncated**
  (C cast) to uint8,
* output gray RGBA with the *input* pixel's alpha preserved.

The f32 arithmetic is contracted the way the JAX package's is, so the
bytes equal ``tpulab.ops.roberts.roberts_edges`` (see
:mod:`tpulab_torch.ops.cuda.stencil`).  Images travel as packed ``(h, w)``
int32 RGBA planes; :func:`pack_rgba`/:func:`unpack_rgba` convert.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpulab_torch.ops.cuda.stencil import roberts_u32
from tpulab_torch.runtime.device import resolve_device


def pack_rgba(pixels: np.ndarray) -> torch.Tensor:
    """(h, w, 4) uint8 RGBA -> (h, w) int32 plane of the same bytes (host)."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim != 3 or pixels.shape[2] != 4:
        raise ValueError(f"expected (h, w, 4) uint8 array, got {pixels.shape}")
    return torch.from_numpy(pixels.view(np.int32)[..., 0].copy())


def unpack_rgba(u: torch.Tensor) -> np.ndarray:
    """(h, w) int32 plane (any device) -> (h, w, 4) uint8 RGBA on the host."""
    return u.cpu().numpy().view(np.uint8).reshape(*u.shape, 4)


def roberts_staged(
    pixels: np.ndarray,
    *,
    launch: Optional[Tuple[int, int, int, int]] = None,
    device: torch.device,
) -> Tuple[Callable, tuple]:
    """(fn, staged_args): the image on ``device`` once, ``fn`` the single
    launch — what the lab times (kernel-only contract)."""
    x = pack_rgba(pixels).to(device)
    return (lambda img: roberts_u32(img, launch)), (x,)


def roberts_edges(
    pixels: np.ndarray,
    *,
    launch: Optional[Tuple[int, int, int, int]] = None,
    backend: Optional[str] = None,
) -> np.ndarray:
    """RGBA (h, w, 4) uint8 -> RGBA gray edge image, alpha preserved."""
    fn, args = roberts_staged(pixels, launch=launch, device=resolve_device(backend))
    return unpack_rgba(fn(*args))
