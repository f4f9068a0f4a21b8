"""Kernel timing with the reference suite's stdout contract.

The reference brackets only the kernel with CUDA events and prints
``"CUDA execution time: <T ms>"`` as the first stdout line (reference
``lab1/src/to_plot.cu:67-82``); the harness extracts the time with the
regex ``r"execution time: <([\\d.]+) ms>"`` (reference ``tester.py:16``).

On the card :func:`measure_kernel_ms` is that bracket: ``torch.cuda.Event``
pairs around ``iters`` launches on inputs already on the device, warm-up
launches excluded.  A spin kernel queued first keeps the stream busy while
the host enqueues the launches, so the events see the launches back to
back and not the host's enqueue rate.  The events read the device's own
clock, so the host round-trip calibration of the JAX package's timer (its
``_rtt_stats``/``_force``, which subtracted a measured dispatch-and-fetch
latency from wall-clock batches) has nothing left to correct and is gone.
On the CPU the bracket is ``time.perf_counter``.

Every call of ``fn`` takes the same input, never the previous call's
output, so :func:`measure_kernel_ms` also serves where the JAX package
needs its queue-amortised ``measure_ms`` (``tpulab/runtime/timing.py:149``):
hw2, lab5 and the sort and reduction bench rows, where a chained timer
would time sorts of sorted data (``tpulab/labs/hw2.py:37-44``).
"""

from __future__ import annotations

import re
import statistics
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

TIMING_LINE_PATTERN = re.compile(r"execution time: <([\d.]+) ms>")
DEVICE_WORD_PATTERN = re.compile(r"^\s*(\w+) execution time:")

# spin-kernel length per millisecond of host enqueue time to cover; an
# H100 SXM boosts to 1.98 GHz, so this covers at least that long
_SPIN_CYCLES_PER_MS = 2_000_000


def summarize_samples(samples: Sequence[float],
                      resolution_ms: Optional[float] = None) -> dict:
    """Variance summary for per-call timing samples (ms).

    ``min`` is the n-run floor (least-contended trial), ``iqr`` the
    p25-p75 width.  ``resolution_ms``, if given, is the measurement
    method's smallest distinguishable-from-zero per-call time: the floor
    statistics are clamped to it and it is reported alongside them.
    """
    arr = np.asarray(list(samples), dtype=np.float64)
    if resolution_ms is not None:
        arr = np.maximum(arr, resolution_ms)
    p25, p75 = (float(v) for v in np.percentile(arr, [25.0, 75.0]))
    out = {
        "median_ms": float(np.median(arr)),
        "min_ms": float(arr.min()),
        "p25_ms": p25,
        "p75_ms": p75,
        "iqr_ms": p75 - p25,
        "n_trials": int(arr.size),
    }
    if resolution_ms is not None:
        out["resolution_ms"] = float(resolution_ms)
    return out


def format_timing_line(device_label: str, ms: float) -> str:
    """First-stdout-line timing contract, e.g. ``CUDA execution time: <0.123456 ms>``."""
    return f"{device_label} execution time: <{ms:f} ms>"


def parse_timing_line(text: str) -> Optional[float]:
    """Extract the kernel time from program stdout (harness side)."""
    match = TIMING_LINE_PATTERN.search(text)
    return float(match.group(1)) if match else None


def parse_timing_device(text: str) -> Optional[str]:
    """Device word from the timing line (``CUDA``/``CPU``)."""
    match = DEVICE_WORD_PATTERN.match(text)
    return match.group(1) if match else None


def measure_kernel_ms(
    fn: Callable,
    args: Sequence[Any] = (),
    *,
    device: torch.device,
    iters: int = 100,
    warmup: int = 2,
    outer: int = 3,
    collect: Optional[list] = None,
) -> Tuple[float, Any]:
    """Per-call time of ``fn(*args)`` on ``device``; ``(ms, last output)``.

    ``warmup`` untimed calls come first, then ``outer`` trials of
    ``iters`` calls each; a trial's time over ``iters`` is one sample, and
    the median of the samples is the result.  ``collect``, if given,
    receives the samples.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    iters = max(iters, 1)
    samples = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn(*args)  # host cost of one enqueue, to size the spin
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize(device)
        for _ in range(max(outer, 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(2 * iters * host_ms * _SPIN_CYCLES_PER_MS) + 1)
            start.record()
            for _ in range(iters):
                out = fn(*args)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / iters)
    else:
        for _ in range(max(outer, 1)):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            samples.append((time.perf_counter() - t0) * 1e3 / iters)
    if collect is not None:
        collect.extend(samples)
    return statistics.median(samples), out



def measure_call_ms(fn: Callable, *, device: torch.device, reps: int = 3, warmup: int = 1,
                    collect: Optional[list] = None) -> Tuple[float, Any]:
    """Time of one call of ``fn()`` on ``device``; ``(median ms, last
    output)``.  For a loop that the host drives (a decode run, a train
    step, a forward of many launches), where a call's host work belongs in
    its time: on the card ``torch.cuda.Event`` pairs around each call after
    a synchronize, on the CPU ``time.perf_counter``.  ``warmup`` untimed
    calls come first; ``collect``, if given, receives every call's ms."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn()
    samples = []
    for _ in range(max(reps, 1)):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            samples.append((time.perf_counter() - t0) * 1e3)
    if collect is not None:
        collect.extend(samples)
    return statistics.median(samples), out
