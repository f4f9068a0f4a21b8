"""Harness data model and the workload-processor interface.

The processor interface is the L3 adapter layer of the suite (the role
the reference's ``BaseLabProcessor`` plays, reference ``tester.py:59-91``):
input synthesis / dataset iteration, stdin serialization, result parsing
and golden verification, per workload.  ``pre_process`` uniformly accepts
``device_info`` (fixing the reference's lab1 TypeError regression,
SURVEY.md section 2.4).
"""

from __future__ import annotations

import abc
import asyncio
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class PreparedRun:
    """One run's inputs: the stdin payload plus verification context."""

    stdin_text: str
    verify_ctx: Any = None
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RunRecord:
    """One executed run (success or failure) — a row of the results table."""

    bin_name: str
    device: str
    kernel_size: str
    time_kernel_ms: Optional[float] = None
    time_wall_ms: Optional[float] = None
    verified: Optional[bool] = None
    error: Optional[str] = None
    #: backend self-reported in the timing line (may differ from the
    #: target's nominal ``device`` label, e.g. f64 paths run on CPU)
    device_reported: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def as_row(self) -> Dict[str, Any]:
        row = {
            "bin_name": self.bin_name,
            "device": self.device,
            "kernel_size": self.kernel_size,
            "time_kernel_ms": self.time_kernel_ms,
            "time_wall_ms": self.time_wall_ms,
            "verified": self.verified,
            "error": self.error,
            "device_reported": self.device_reported,
        }
        row.update(self.metadata)
        return row


class WorkloadProcessor(abc.ABC):
    """Per-workload adapter driving one experiment family.

    Subclasses are seeded-deterministic: the numpy generator in
    ``self.rng`` reproduces the same input stream for a given seed
    (the reference seeds global numpy state, tester.py:60-62; a local
    generator is the non-global equivalent).
    """

    def __init__(self, seed: int = 42):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._lock = asyncio.Lock()

    def get_attrs(self) -> Dict[str, Any]:
        """Static metadata attached to every run row."""
        return {"seed": self.seed}

    @abc.abstractmethod
    async def pre_process(self, device_info: str = "", **kwargs) -> PreparedRun:
        """Produce one run's stdin payload + verification context."""

    @abc.abstractmethod
    async def verify(self, result: Any, prepared: PreparedRun) -> bool:
        """Check one run's output; golden-less runs return True."""

    async def load_result(self, stdout_payload: str, prepared: PreparedRun) -> Any:
        """Parse the run's result from the stdout payload (after the timing
        line) or from the output file recorded in ``prepared``."""
        return stdout_payload

    def serialize_kernel_size(self, kernel_size: Optional[Sequence]) -> str:
        """Render one kernel_sizes entry as the stdin prefix lines
        (reference tester.py:113-121 semantics, per-lab layout)."""
        if kernel_size is None or all(v is None for v in _flatten(kernel_size)):
            return ""
        return "\n".join(str(v) for v in _flatten(kernel_size)) + "\n"


def _flatten(ks) -> List:
    out = []
    for v in ks if isinstance(ks, (list, tuple)) else [ks]:
        if isinstance(v, (list, tuple)):
            out.extend(_flatten(v))
        else:
            out.append(v)
    return out
