"""Benchmark rows of the lab suite on the card: ``tpulab_torch bench``.

The JAX package's lab rows (``tpulab/bench.py:18-82,1653-1703``,
``tpulab/bench_image.py``) with the same metric names, sizes and spread
fields, each measured on the resolved device:

* ``lab1_subtract_n1000_float64_median_ms`` and the float32 n=2^20 row;
* ``lab2_roberts_1024x1024_median_ms`` (the repo's headline, ``bench.py:38``);
* ``lab3_classify_1024x1024_nc8_median_ms`` (float64, the reference's ``double``);
* ``hw2_sort_n1048576_f32_median_ms``;
* ``lab5_reduce_sum_n16777216_i32_median_ms``.

Every row says ``"device": "cuda"`` (or ``"cpu"`` where ``backend="cpu"``
asks for the host) and, on the card, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` gives them.  The lab kernels
are timed by :func:`~tpulab_torch.runtime.timing.measure_kernel_ms`, every
call on the same staged input (the JAX package's sort and reduction rows
take its queue-amortised ``measure_ms`` for that reason).  ``vs_baseline`` divides
the reference suite's RTX A6000 median (``BASELINE.md``) by this row's.
The model rows of the JAX package's bench are not here yet (ROADMAP A6).
"""

from __future__ import annotations

import functools
import inspect
import subprocess
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from tpulab_torch.runtime.device import resolve_device
from tpulab_torch.runtime.timing import measure_kernel_ms, summarize_samples

# Best-config CUDA medians of the reference suite on an RTX A6000
# (BASELINE.md); keys with no published number are absent.
CUDA_BASELINES_MS = {
    "lab1_n1000": 0.14336,         # lab1 [512,512]
    "lab2_roberts_1024": 0.17866,  # lab2 large-tier best [[32,32],[16,16]]
}


def variance_fields(samples) -> Dict[str, Any]:
    """Flat spread fields (min/p25/p75/iqr/n) of a row, to 6 significant digits."""
    if not samples:
        return {}
    return {k: (float(f"{v:.6g}") if isinstance(v, float) else v)
            for k, v in summarize_samples(samples).items()}


@functools.lru_cache(maxsize=None)
def card_fields(device_type: str) -> Dict[str, Any]:
    """``device`` and, on the card, its name and power limit (``nvidia-smi``)."""
    if device_type != "cuda":
        return {"device": device_type}
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        name, limit = (v.strip() for v in res.stdout.splitlines()[0].split(","))
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        name, limit = torch.cuda.get_device_name(0), "not measured"
    return {"device": "cuda", "card": name, "power_limit": limit}


def _row(metric: str, ms: float, device: torch.device, samples, base: Optional[float] = None):
    return {
        "metric": metric,
        "value": round(ms, 6),
        "unit": "ms",
        "vs_baseline": round(base / ms, 3) if base else None,
        **card_fields(device.type),
        **variance_fields(samples),
    }


def _test_image(h: int, w: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, 256, size=(h, w, 4), dtype=np.uint8)


def bench_lab1(n: int = 1000, dtype: str = "float64", iters: int = 500,
               backend: Optional[str] = None) -> Dict[str, Any]:
    from tpulab_torch.ops.cuda.elementwise import binary
    from tpulab_torch.ops.elementwise import stage_vector

    device = resolve_device(backend)
    rng = np.random.default_rng(0)
    a = stage_vector(rng.uniform(-1e3, 1e3, n), dtype, device)
    b = stage_vector(rng.uniform(-1e3, 1e3, n), dtype, device)
    samples: list = []
    ms, _ = measure_kernel_ms(lambda x, y: binary("subtract", x, y), (a, b), device=device,
                              iters=iters, outer=11, collect=samples)
    base = CUDA_BASELINES_MS["lab1_n1000"] if n == 1000 and dtype == "float64" else None
    return _row(f"lab1_subtract_n{n}_{dtype}_median_ms", ms, device, samples, base)


def bench_lab2(size: int = 1024, iters: int = 500,
               backend: Optional[str] = None) -> Dict[str, Any]:
    from tpulab_torch.ops.roberts import roberts_staged

    device = resolve_device(backend)
    fn, args = roberts_staged(_test_image(size, size), device=device)
    samples: list = []
    ms, _ = measure_kernel_ms(fn, args, device=device, iters=iters, outer=11, collect=samples)
    return _row(f"lab2_roberts_{size}x{size}_median_ms", ms, device, samples,
                CUDA_BASELINES_MS["lab2_roberts_1024"])


def bench_lab3(size: int = 1024, nc: int = 8, iters: int = 500,
               backend: Optional[str] = None) -> Dict[str, Any]:
    from tpulab_torch.ops.mahalanobis import class_statistics, classify_staged

    device = resolve_device(backend)
    rng = np.random.default_rng(11)
    img = _test_image(size, size)
    classes = [np.stack([rng.integers(0, size, 16), rng.integers(0, size, 16)], axis=1)
               for _ in range(nc)]
    fn, args = classify_staged(img, class_statistics(img, classes), device=device)
    samples: list = []
    ms, _ = measure_kernel_ms(fn, args, device=device, iters=iters, outer=11, collect=samples)
    return _row(f"lab3_classify_{size}x{size}_nc{nc}_median_ms", ms, device, samples)


def bench_sort(n: int = 1 << 20, reps: int = 50,
               backend: Optional[str] = None) -> Dict[str, Any]:
    """hw2/lab5 sort tier: n float32 keys, every timed call on the same
    unsorted input."""
    from tpulab_torch.ops.sortops import sort_ascending

    device = resolve_device(backend)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    samples: list = []
    ms, _ = measure_kernel_ms(sort_ascending, (x.to(device),), device=device, iters=reps,
                              warmup=3, outer=7, collect=samples)
    return _row(f"hw2_sort_n{n}_f32_median_ms", ms, device, samples)


def bench_reduce(n: int = 1 << 24, reps: int = 50,
                 backend: Optional[str] = None) -> Dict[str, Any]:
    """lab5 reduction tier: the sum of n int32, widened to int64."""
    from tpulab_torch.ops.reduction import reduce_values

    device = resolve_device(backend)
    x = torch.from_numpy(np.random.default_rng(0).integers(-100, 100, n).astype(np.int32))
    samples: list = []
    ms, _ = measure_kernel_ms(lambda v: reduce_values(v, "sum"), (x.to(device),),
                              device=device, iters=reps, warmup=3, outer=7, collect=samples)
    return _row(f"lab5_reduce_sum_n{n}_i32_median_ms", ms, device, samples)


REGISTRY = {
    "lab1_n1000": functools.partial(bench_lab1, 1000),
    "lab1_f32_1m": functools.partial(bench_lab1, 1 << 20, dtype="float32"),
    "lab2_roberts_1024": bench_lab2,
    "lab3_classify_1024": bench_lab3,
    "hw2_sort": bench_sort,
    "lab5_reduce": bench_reduce,
}


def run_benchmarks(only: Optional[str] = None, **kw) -> Iterator[Dict[str, Any]]:
    """Rows of every registered benchmark (or those whose name holds
    ``only``), one at a time.  Extra kwargs (``backend``, ``size``,
    ``iters``, ``reps``, ``n``, ...) go to each benchmark that declares
    them.  An error is raised, not turned into a row."""
    for name, fn in REGISTRY.items():
        if only and only not in name:
            continue
        base = fn.func if isinstance(fn, functools.partial) else fn
        params = list(inspect.signature(base).parameters)
        bound = (set(params[: len(fn.args)]) | set(fn.keywords)
                 if isinstance(fn, functools.partial) else set())
        yield fn(**{k: v for k, v in kw.items() if k in params and k not in bound})
