"""Per-pixel Mahalanobis-distance classification (the lab3 workload).

Two stages, mirroring the reference's host/device split
(reference ``lab3/src/main.cu:78-158``):

1. **Host statistics** (float64 NumPy, as host-side in the reference):
   per-class RGB mean over the sample pixels (main.cu:106-117), covariance
   normalized by ``np-1`` (main.cu:119-139; degenerate/NaN when a class
   has one point — preserved), and the inverse via determinant + adjugate
   with the reference's index scheme (main.cu:141-150, which builds the
   transposed adjugate — for the symmetric covariance this equals the true
   inverse).  The same arithmetic as ``tpulab.ops.mahalanobis``, so the
   two packages classify against identical statistics.
2. **Device classify**: for every pixel, ``argmin_c (p-mu_c)^T S_c^-1
   (p-mu_c)`` with strict-< tie-breaking (first minimal class wins,
   main.cu:68-71), label written into the alpha channel (main.cu:73), by
   :mod:`tpulab_torch.ops.cuda.classify`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from tpulab_torch.ops.cuda.classify import MAX_CLASSES, classify_u32, pack_stats
from tpulab_torch.ops.roberts import pack_rgba, unpack_rgba
from tpulab_torch.runtime.device import resolve_device

COMPUTE_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclass
class ClassStats:
    mean: np.ndarray     # (nc, 3) float64
    inv_cov: np.ndarray  # (nc, 3, 3) float64


def class_statistics(pixels: np.ndarray, classes: Sequence[np.ndarray]) -> ClassStats:
    """Float64 per-class statistics from sample-pixel coordinates.

    ``classes[c]`` is an ``(np_c, 2)`` array of ``(x, y)`` coordinates into
    the image (the lab3 stdin grammar's class definition rows).
    """
    if len(classes) > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes (reference MAX_CLASSES)")
    nc = len(classes)
    mean = np.zeros((nc, 3), np.float64)
    inv_cov = np.zeros((nc, 3, 3), np.float64)
    for c, pts in enumerate(classes):
        pts = np.asarray(pts, np.int64).reshape(-1, 2)
        samples = pixels[pts[:, 1], pts[:, 0], :3].astype(np.float64)  # (np, 3) RGB
        n = len(samples)
        mu = samples.sum(axis=0) / n
        mean[c] = mu
        diff = samples - mu
        cov = diff.T @ diff  # sum of outer products (main.cu:128-132)
        with np.errstate(divide="ignore", invalid="ignore"):
            cov = cov / (n - 1)  # degenerate for n==1, as in main.cu:137
            det = (
                cov[0, 0] * (cov[1, 1] * cov[2, 2] - cov[2, 1] * cov[1, 2])
                - cov[0, 1] * (cov[1, 0] * cov[2, 2] - cov[1, 2] * cov[2, 0])
                + cov[0, 2] * (cov[1, 0] * cov[2, 1] - cov[1, 1] * cov[2, 0])
            )
            # adjugate/det with the reference's (transposing) index scheme
            for a in range(3):
                for b in range(3):
                    inv_cov[c, a, b] = (
                        cov[(b + 1) % 3, (a + 1) % 3] * cov[(b + 2) % 3, (a + 2) % 3]
                        - cov[(b + 1) % 3, (a + 2) % 3] * cov[(b + 2) % 3, (a + 1) % 3]
                    ) / det
    return ClassStats(mean=mean, inv_cov=inv_cov)


def classify_staged(
    pixels: np.ndarray,
    stats: ClassStats,
    *,
    launch: Optional[Tuple[int, int]] = None,
    device: torch.device,
    compute_dtype: str = "float64",
) -> Tuple[Callable, tuple]:
    """(fn, staged_args): image and statistics on ``device`` once, ``fn``
    the single launch — what the lab times (kernel-only contract).

    ``compute_dtype`` is ``"float64"`` (the reference's ``double``, the
    default on every device) or ``"float32"`` (what the TPU kernel
    computed).
    """
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"unsupported compute_dtype {compute_dtype!r}; have {sorted(COMPUTE_DTYPES)}"
        )
    x = pack_rgba(pixels).to(device)
    s = pack_stats(stats.mean, stats.inv_cov, COMPUTE_DTYPES[compute_dtype], device)
    return (lambda img, st: classify_u32(img, st, launch)), (x, s)


def classify(
    pixels: np.ndarray,
    stats: ClassStats,
    *,
    launch: Optional[Tuple[int, int]] = None,
    backend: Optional[str] = None,
    compute_dtype: str = "float64",
) -> np.ndarray:
    """Full lab3 op: labels written into the alpha channel, RGB preserved."""
    fn, args = classify_staged(
        pixels, stats, launch=launch, device=resolve_device(backend),
        compute_dtype=compute_dtype,
    )
    return unpack_rgba(fn(*args))
