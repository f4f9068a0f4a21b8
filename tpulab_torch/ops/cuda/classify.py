"""Kernel B3: per-pixel Mahalanobis argmin, label into alpha.

Replaces ``tpulab/ops/pallas/classify.py::_classify_kernel`` (reached
through ``classify_labels_pallas``) and the label-into-alpha packing of
``tpulab/ops/mahalanobis.py:114-128``.  The CUDA kernel
(``csrc/classify.cu``) runs in float64 (lab3's default, the reference's
``double``) or float32 (what the TPU kernel computed), as a grid-stride
loop over the literal ``(blocks, threads)`` launch.  Both instances
screen the classes in float32; in float64 a rigorous margin leaves one or
two candidates, which the reference's double fold decides, so the labels
are the double fold's bit for bit (the derivation heads
``csrc/classify.cu``).

The class statistics travel as one ``(nc, 12)`` tensor of the compute
dtype: each row is the class mean (3 values) then its inverse covariance
(3x3, row-major).  The kernel reads them from its launch parameter, a
:class:`Screen` staged once on the host by :func:`stage_screen`: the float64
rows, their float32 roundings, and each class's margin and "always
recheck" flag.  Images travel as packed ``(h, w)`` int32 RGBA planes.

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

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from tpulab_torch.ops.cuda import _build
from tpulab_torch.runtime.fpenv import ensure_nearest

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


#: a class's screen margin per unit of its magnitude bound: 64 units of
#: float32 roundoff, over five times the screen's and the fold's error
MARGIN_SCALE = 2.0**-18
#: nonzero |mean| and |inverse covariance| values the float32 screen keeps
#: normal; a class with one outside is always rechecked
SCREEN_RANGE = (2.0**-60, 2.0**60)
#: the largest magnitude bound whose screen values all stay finite in float32
MAX_BOUND = 2.0**120


@dataclass(frozen=True)
class Screen:
    """The kernel's launch parameter, staged once on the host by
    :func:`stage_screen` (the derivation heads ``csrc/classify.cu``).

    ``rows32`` are the float32 rows the screen reads: the roundings of
    ``rows64``, and in float64 NaN for a flagged class, so that it never
    sets the screen's minimum.  ``margin`` (float32, rounded up) and
    ``recheck`` are used by the float64 instance only.  ``param`` is the
    packed ``Params`` struct of the C side.
    """

    dtype: torch.dtype
    rows64: np.ndarray   # (nc, 12) float64
    rows32: np.ndarray   # (nc, 12) float32
    margin: np.ndarray   # (nc,) float32
    recheck: np.ndarray  # (nc,) bool
    param: bytes = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        nc = self.rows64.shape[0]
        pad = MAX_CLASSES - nc
        rows64 = np.pad(np.asarray(self.rows64, np.float64), ((0, pad), (0, 0)))
        rows32 = np.pad(np.asarray(self.rows32, np.float32), ((0, pad), (0, 0)))
        margin = np.pad(np.asarray(self.margin, np.float32), (0, pad))
        bits = int(sum(1 << c for c in np.flatnonzero(self.recheck)))
        tail = np.array([bits, nc], np.uint32)
        object.__setattr__(self, "param", b"".join(
            a.tobytes() for a in (rows64, rows32, margin, tail)))

    @property
    def nc(self) -> int:
        return self.rows64.shape[0]


def stage_screen(mean: np.ndarray, inv_cov: np.ndarray, dtype: torch.dtype) -> Screen:
    """The :class:`Screen` of the statistics :func:`pack_stats` packs.

    In float64, each class's magnitude bound ``A_c = sum_ij M_j |IC_ji|
    M_i`` with ``M_j = max(|mu_j|, |255 - mu_j|)``, its margin ``2^-18
    A_c`` rounded up to float32, and its flag: a non-finite statistic, a
    nonzero one outside ``SCREEN_RANGE``, or ``A_c`` above ``MAX_BOUND``.
    """
    rows64 = pack_stats(mean, inv_cov, torch.float64, torch.device("cpu")).numpy()
    with np.errstate(over="ignore"):
        rows32 = rows64.astype(np.float32)
    nc = rows64.shape[0]
    if dtype == torch.float32:
        return Screen(dtype, rows64, rows32, np.zeros(nc, np.float32), np.zeros(nc, bool))
    if dtype != torch.float64:
        raise ValueError(f"expected float64 or float32, got {dtype}")
    with np.errstate(all="ignore"):
        mu, ic = rows64[:, :3], np.abs(rows64[:, 3:].reshape(-1, 3, 3))
        m = np.maximum(np.abs(mu), np.abs(255.0 - mu))
        # the float64 sum of 9 products rounds by far less than 2^-40
        bound = np.einsum("cj,cji,ci->c", m, ic, m) * (1.0 + 2.0**-40)
        mag = np.abs(rows64)
        in_range = ((mag == 0) | ((mag >= SCREEN_RANGE[0]) & (mag <= SCREEN_RANGE[1]))).all(1)
        recheck = ~(np.isfinite(rows64).all(1) & in_range & (bound <= MAX_BOUND))
        want = np.where(recheck, 0.0, bound * MARGIN_SCALE)
        margin = want.astype(np.float32)
    margin = np.where(margin < want, np.nextafter(margin, np.float32(np.inf)), margin)
    rows32[recheck] = np.nan
    return Screen(dtype, rows64, rows32, margin, recheck)


def _add_ru32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a + b`` rounded up (``__fadd_ru``), for finite operands."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    s = a64 + b64
    err = (a64 - (s - (s - a64))) + (b64 - (s - a64))  # TwoSum: the exact sum is s + err
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    low = (r64 < s) | ((r64 == s) & (err > 0))
    return torch.where(low, torch.nextafter(r, torch.full_like(r, float("inf"))), r)


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


def screen_plain(
    u: torch.Tensor, screen: Screen, contracted: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 instance's screen and recheck in plain PyTorch:
    ``(candidates, labels)`` for a packed int32 plane, the candidates as
    one int64 bit mask per pixel.  ``contracted=False`` forms the float32
    distances with every operation rounded on its own instead of the
    kernel's fused multiply-adds; the margins cover both orders."""
    if screen.dtype != torch.float64:
        raise ValueError(f"the recheck runs in float64 only, got a {screen.dtype} screen")
    dev = u.device
    rows32 = torch.from_numpy(screen.rows32).to(dev)
    rows64 = torch.from_numpy(screen.rows64).to(dev)
    margin = torch.from_numpy(screen.margin).to(dev)
    planes = [((u >> shift) & 0xFF).to(torch.float32) for shift in (0, 8, 16)]
    dists = []
    min32 = torch.full(u.shape, float("inf"), dtype=torch.float32, device=dev)
    min_margin = torch.zeros(u.shape, dtype=torch.float32, device=dev)
    for c in range(screen.nc):
        s = rows32[c]
        dist = _distance([planes[i] - s[i] for i in range(3)], s[3:], contracted)
        better = dist < min32  # strict <: the first minimal class wins, NaN never
        min32 = torch.where(better, dist, min32)
        min_margin = torch.where(better, margin[c], min_margin)
        dists.append(dist)
    finite = torch.isfinite(min32)
    base = _add_ru32(torch.where(finite, min32, 0.0), min_margin)
    cand = torch.zeros(u.shape, dtype=torch.int64, device=dev)
    for c, dist in enumerate(dists):
        hit = ~finite | (dist <= _add_ru32(base, margin[c].expand_as(base)))
        if screen.recheck[c]:
            hit = torch.ones_like(hit)
        cand |= hit.to(torch.int64) << c
    best = torch.full_like(u, -1)
    best_dist = torch.full(u.shape, float("inf"), dtype=torch.float64, device=dev)
    planes64 = [p.to(torch.float64) for p in planes]
    for c in range(screen.nc):
        s = rows64[c]
        dist = _distance([planes64[i] - s[i] for i in range(3)], s[3:], contracted=False)
        better = (((cand >> c) & 1) == 1) & (dist < best_dist)
        best = torch.where(better, c, best)
        best_dist = torch.where(better, dist, best_dist)
    return cand, (u & 0x00FFFFFF) | ((best & 0xFF) << 24)


def default_launch(n: int) -> Tuple[int, int]:
    """``(blocks, threads)`` with one thread per pixel."""
    return min(max(1, -(-n // DEFAULT_THREADS)), 2**31 - 1), DEFAULT_THREADS


def classify_u32(
    u: torch.Tensor,
    stats: torch.Tensor,
    launch: Optional[Tuple[int, int]] = None,
    screen: Optional[Screen] = None,
) -> torch.Tensor:
    """Label every pixel of a packed int32 RGBA tensor by its nearest class.

    ``stats`` is the ``(nc, 12)`` tensor of :func:`pack_stats`; its dtype
    is the compute dtype.  ``launch`` is the reference sweep's ``(blocks,
    threads)``, launched as given.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel, whose parameter is ``screen``, the
    :func:`stage_screen` of the same statistics (required there).
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
    if screen is not None and (screen.dtype != stats.dtype or screen.nc != stats.shape[0]):
        raise ValueError(f"a {screen.dtype} screen of {screen.nc} classes for {stats.dtype} "
                         f"statistics of {stats.shape[0]}")
    blocks, threads = launch if launch is not None else default_launch(u.numel())
    _build.check_geometry((blocks,), (threads,))
    if u.device.type == "cpu":
        ensure_nearest()
        return classify_u32_plain(u, stats)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    if screen is None:
        raise ValueError("the kernel's parameter is a Screen: pass stage_screen(mean, inv_cov, "
                         "dtype) of the same statistics")
    out = torch.empty_like(u)
    lib = _build.load_library()
    rc = lib.tl_classify(
        DTYPES[stats.dtype], u.data_ptr(), out.data_ptr(), screen.param,
        screen.nc, u.numel(), blocks, threads, _build.stream_handle(u.device),
    )
    classify_u32.launches += 1
    _build.check_launch(rc, "classify kernel")
    return out


classify_u32.launches = 0
