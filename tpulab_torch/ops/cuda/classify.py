"""Kernel B3: per-pixel Mahalanobis argmin, label into alpha.

Replaces ``tpulab/ops/pallas/classify.py::_classify_kernel`` (reached
through ``classify_labels_pallas``) and the label-into-alpha packing of
``tpulab/ops/mahalanobis.py:114-128``.  The CUDA kernel
(``csrc/classify.cu``) runs in float64 (lab3's default, the reference's
``double``) or float32 (what the TPU kernel computed), as a grid-stride
loop over the literal ``(blocks, threads)`` launch.  In float64 it is
bound by the card's FP64 rate: 24 flops per pixel and class.

The class statistics travel as one ``(nc, 12)`` tensor of the compute
dtype: each row is the class mean (3 values) then its inverse covariance
(3x3, row-major).  Images travel as packed ``(h, w)`` int32 RGBA planes.

:func:`classify_u32_plain` is the same function in plain PyTorch.  In
float64 every operation rounds on its own, in tpulab's loop order.  In
float32 it reproduces the fused multiply-adds XLA:CPU forms from that
order (see ``csrc/classify.cu``) by computing each one in float64 and
rounding once: the product of two float32 values is exact in float64, and
the sum rounds there only when the addend is more than 32 times the
product, where a second rounding could differ from the hardware ``fma``
only on a float32 rounding midpoint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpulab_torch.ops.cuda import _build

MAX_CLASSES = 32  # reference lab3/src/main.cu:35
STATS_PER_CLASS = 12
DTYPES = {torch.float64: 0, torch.float32: 1}

#: default block when the caller gives no sweep geometry
DEFAULT_THREADS = 256


def pack_stats(
    mean: np.ndarray, inv_cov: np.ndarray, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """``(nc, 3)`` means and ``(nc, 3, 3)`` inverse covariances (float64
    numpy) -> the ``(nc, 12)`` statistics tensor in ``dtype`` on ``device``."""
    mean = np.asarray(mean, np.float64).reshape(-1, 3)
    inv_cov = np.asarray(inv_cov, np.float64).reshape(-1, 9)
    if mean.shape[0] != inv_cov.shape[0] or mean.shape[0] > MAX_CLASSES:
        raise ValueError(
            f"expected matching class counts <= {MAX_CLASSES}, got "
            f"{mean.shape[0]} means and {inv_cov.shape[0]} inverse covariances"
        )
    packed = np.concatenate([mean, inv_cov], axis=1)
    return torch.from_numpy(packed).to(device=device, dtype=dtype).contiguous()


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (see the module note)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def _distance(d, ic, contracted: bool) -> torch.Tensor:
    """The kernel's form: contracted in float32, every operation rounded in float64."""
    if contracted:
        t = [_fma32(d[2], ic[6 + i], _fma32(d[0], ic[i], d[1] * ic[3 + i])) for i in range(3)]
        return _fma32(t[2], d[2], _fma32(t[0], d[0], t[1] * d[1]))
    dist = torch.zeros_like(d[0])
    for i in range(3):
        t = d[0] * ic[i] + d[1] * ic[3 + i] + d[2] * ic[6 + i]
        dist = dist + t * d[i]
    return dist


def classify_u32_plain(u: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch classify: packed RGBA in, label in alpha out."""
    dtype = stats.dtype
    planes = [((u >> shift) & 0xFF).to(dtype) for shift in (0, 8, 16)]
    best = torch.full_like(u, -1)
    best_dist = torch.full(u.shape, float("inf"), dtype=dtype, device=u.device)
    for c in range(stats.shape[0]):
        s = stats[c]
        d = [planes[i] - s[i] for i in range(3)]
        dist = _distance(d, s[3:], contracted=dtype == torch.float32)
        better = dist < best_dist  # strict <: the first minimal class wins, NaN never
        best = torch.where(better, c, best)
        best_dist = torch.where(better, dist, best_dist)
    return (u & 0x00FFFFFF) | ((best & 0xFF) << 24)


def default_launch(n: int) -> Tuple[int, int]:
    """``(blocks, threads)`` with one thread per pixel."""
    return min(max(1, -(-n // DEFAULT_THREADS)), 2**31 - 1), DEFAULT_THREADS


def classify_u32(
    u: torch.Tensor,
    stats: torch.Tensor,
    launch: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Label every pixel of a packed int32 RGBA tensor by its nearest class.

    ``stats`` is the ``(nc, 12)`` tensor of :func:`pack_stats`; its dtype
    is the compute dtype.  ``launch`` is the reference sweep's ``(blocks,
    threads)``, launched as given.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel.
    """
    if u.dtype != torch.int32 or not u.is_contiguous():
        raise ValueError(f"expected a contiguous int32 plane, got {u.dtype}")
    if (
        stats.dtype not in DTYPES
        or stats.dim() != 2
        or stats.shape[1] != STATS_PER_CLASS
        or stats.shape[0] > MAX_CLASSES
        or not stats.is_contiguous()
    ):
        raise ValueError(
            f"expected contiguous (nc <= {MAX_CLASSES}, {STATS_PER_CLASS}) float64 or "
            f"float32 statistics, got {stats.dtype} {tuple(stats.shape)}"
        )
    if stats.device != u.device:
        raise ValueError(f"statistics on {stats.device}, image on {u.device}")
    blocks, threads = launch if launch is not None else default_launch(u.numel())
    _build.check_geometry((blocks,), (threads,))
    if u.device.type == "cpu":
        return classify_u32_plain(u, stats)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    out = torch.empty_like(u)
    lib = _build.load_library()
    rc = lib.tl_classify(
        DTYPES[stats.dtype], u.data_ptr(), out.data_ptr(), stats.data_ptr(),
        stats.shape[0], u.numel(), blocks, threads, _build.stream_handle(u.device),
    )
    classify_u32.launches += 1
    _build.check_launch(rc, "classify kernel")
    return out


classify_u32.launches = 0
