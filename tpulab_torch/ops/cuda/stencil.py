"""Kernel B1: Roberts cross edges over a packed RGBA plane.

Replaces ``tpulab/ops/pallas/stencil.py::_stencil_kernel`` (reached
through ``roberts_pallas``).  The CUDA kernel (``csrc/stencil.cu``) does
the whole function in one launch: luminance, the clamp-addressed 2x2
stencil, the magnitude, clamp and truncation, gray packing with the input
alpha.  It is bound by bytes: one u32 read and one u32 written per pixel.
Each thread walks quads of 4 pixels over strips of 4 rows, computes each
luminance once and issues no conversion instruction; any launch geometry
gives the same bytes, and the default is one resident wave of the card.

The image travels as a ``(h, w)`` int32 tensor holding the little-endian
RGBA bytes of each pixel (R in the low byte), the port's stand-in for a
u32 plane.

:func:`roberts_u32_plain` is the same function in plain PyTorch.  It
reproduces the order in which XLA:CPU contracts the JAX package's f32
arithmetic into fused multiply-adds, by computing in float64 and rounding
to float32 after each step: the products of these f32 operands are exact
in float64, so each ``fma`` rounds once, as the hardware's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpulab_torch.ops.cuda import _build
from tpulab_torch.runtime.fpenv import ensure_nearest

#: default block when the caller gives no sweep geometry
DEFAULT_BLOCK = (256, 1)
#: default blocks on each SM: the kernel's launch bounds cap a thread at 64
#: registers, so 4 blocks of 256 threads are resident at once
BLOCKS_PER_SM = 4
#: streaming multiprocessors of an H100 SXM (the CPU path's default launch)
SMS = 132
#: rows of the strip a kernel thread walks (``kRows`` in ``csrc/stencil.cu``)
STRIP_ROWS = 4
#: the kernel's indices are 32-bit: h * w must stay below this
MAX_PIXELS = 2**31

# the float32 values of the reference's luminance weights, as Python floats
_LUMA_R, _LUMA_G, _LUMA_B = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32).tolist()


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round a float64 tensor to the nearest float32, kept as float64."""
    return x.to(torch.float32).to(torch.float64)


def _luminance(u: torch.Tensor) -> torch.Tensor:
    r = (u & 0xFF).to(torch.float64)
    g = ((u >> 8) & 0xFF).to(torch.float64)
    b = ((u >> 16) & 0xFF).to(torch.float64)
    # fma(0.114f, B, fma(0.299f, R, 0.587f * G))
    return _f32(_LUMA_B * b + _f32(_LUMA_R * r + _f32(_LUMA_G * g)))


def roberts_u32_plain(u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Roberts edges: ``(h, w)`` packed RGBA in, same out."""
    h, w = u.shape
    y = _luminance(u)
    xi = torch.clamp(torch.arange(1, w + 1, device=u.device), max=w - 1)
    yi = torch.clamp(torch.arange(1, h + 1, device=u.device), max=h - 1)
    y10 = y[:, xi]      # (x+1, y), clamped
    y01 = y[yi, :]      # (x, y+1), clamped
    y11 = y01[:, xi]    # (x+1, y+1), clamped
    gx = _f32(y11 - y)
    gy = _f32(y10 - y01)
    # sqrtf(fma(gx, gx, gy * gy)); sqrt in float64 then one rounding is
    # the correctly rounded float32 square root
    m = _f32(torch.sqrt(_f32(gx * gx + _f32(gy * gy))))
    g8 = torch.clamp(m, 0.0, 255.0).to(torch.int32)  # truncation after the clamp
    return g8 | (g8 << 8) | (g8 << 16) | (u & -0x1000000)


def default_launch(h: int, w: int, sms: int = SMS) -> Tuple[int, int, int, int]:
    """``(bx, by, gx, gy)``: at most one resident wave on ``sms`` SMs, and
    no more blocks than the image has quads x strips of work; the kernel's
    grid-stride loop covers any image with it."""
    bx, by = DEFAULT_BLOCK
    work = -(-w // 4) * -(-h // STRIP_ROWS)
    return bx, by, max(1, min(BLOCKS_PER_SM * sms, -(-work // (bx * by)))), 1


def roberts_u32(
    u: torch.Tensor, launch: Optional[Tuple[int, int, int, int]] = None
) -> torch.Tensor:
    """Roberts edges of a packed ``(h, w)`` int32 RGBA plane.

    ``launch`` is the reference sweep's ``(bx, by, gx, gy)``: block
    ``(bx, by)``, grid ``(gx, gy)``, launched as given.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel.
    """
    if u.dtype != torch.int32 or u.dim() != 2 or not u.is_contiguous():
        raise ValueError(
            f"expected a contiguous (h, w) int32 plane, got {u.dtype} {tuple(u.shape)}"
        )
    h, w = u.shape
    if h * w >= MAX_PIXELS:
        raise ValueError(f"a {h} x {w} plane has {h * w} pixels; the kernel takes fewer than "
                         f"{MAX_PIXELS}")
    if launch is None:
        launch = default_launch(h, w, _build.sm_count(u.device) if u.device.type == "cuda" else SMS)
    bx, by, gx, gy = launch
    _build.check_geometry((gx, gy), (bx, by))
    if u.device.type == "cpu":
        ensure_nearest()
        return roberts_u32_plain(u)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    out = torch.empty_like(u)
    lib = _build.load_library()
    rc = lib.tl_roberts(
        u.data_ptr(), out.data_ptr(), h, w, bx, by, gx, gy, _build.stream_handle(u.device)
    )
    roberts_u32.launches += 1
    _build.check_launch(rc, "roberts kernel")
    return out


roberts_u32.launches = 0
