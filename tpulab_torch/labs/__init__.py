"""Workload entry points speaking the suite's stdin/stdout contract.

Every workload reads whitespace-delimited parameters/payload from stdin,
prints a ``"<DEVICE> execution time: <T ms>"`` line first, and emits its
payload to stdout or an output file — the exact contract of the reference
binaries (see :mod:`tpulab_torch.io.protocol`).
"""

from __future__ import annotations

import importlib
import sys
from typing import List, Optional

WORKLOADS = ("lab1", "lab2", "lab3", "lab5", "hw1", "hw2", "gpu_info")


def get_workload(name: str):
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {WORKLOADS}")
    return importlib.import_module(f"tpulab_torch.labs.{name}")


def run_workload(
    name: str,
    sweep: bool = False,
    backend: Optional[str] = None,
    extra: Optional[List[str]] = None,
    stdin_text: Optional[str] = None,
) -> int:
    """Run one workload over the stdin/stdout protocol; returns exit code."""
    from tpulab_torch.runtime.device import resolve_device
    from tpulab_torch.utils.argcfg import coerce_cli_kwargs

    mod = get_workload(name)
    cfg = coerce_cli_kwargs(extra or [])
    resolve_device(backend)  # no card and no cpu request: fail before reading stdin
    text = stdin_text if stdin_text is not None else sys.stdin.read()
    out = mod.run(text, sweep=sweep, backend=backend, **cfg)
    sys.stdout.write(out)
    sys.stdout.flush()
    return 0
