"""Device-level profiling and bracketed event logging (the heavy tier).

The port has two tracing surfaces, as ``tpulab`` has:

* the always-on host timeline, :mod:`tpulab_torch.obs.tracer`: a
  preallocated ring buffer, one tuple append per event, cheap enough for
  production serving;
* opt-in device profiling (this module): a ``torch.profiler`` trace
  (CUDA kernels beside the host ops, through CUPTI) and the reference
  harness's ``[tag]`` event log.  :func:`annotate` names a region in that
  trace (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the CPU and, where a card is
    visible, CUDA activity when ``trace_dir`` is set (written there as a
    Chrome trace on exit, loadable in Perfetto); a no-op otherwise."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in profiler timelines."""
    with torch.profiler.record_function(name):
        yield


class EventLog:
    """Bracketed-tag event log (`[Experiment]`-style, reference
    tester.py:197-293) with optional JSONL persistence."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def event(self, tag: str, message: str = "", **fields) -> None:
        rec = {"t": time.time(), "tag": tag, "message": message, **fields}
        if self.echo:
            extra = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{tag}] {message}{(' ' + extra) if extra else ''}")
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    @contextlib.contextmanager
    def timed(self, tag: str, message: str = "") -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.event(tag, message,
                       elapsed_ms=round((time.perf_counter() - t0) * 1e3, 3))

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
