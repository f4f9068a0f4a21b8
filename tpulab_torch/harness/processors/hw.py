"""hw1/hw2 processors: synthetic inputs + exact/semantic oracles."""

from __future__ import annotations

from typing import Any

import numpy as np

from tpulab_torch.harness.base import PreparedRun, WorkloadProcessor
from tpulab_torch.io import protocol
from tpulab_torch.ops.quadratic import solve_scalar


class Hw1Processor(WorkloadProcessor):
    """Random coefficient triples (including degenerate a=0/b=0 cases);
    oracle = the scalar f32 solver's exact output line."""


    def __init__(self, seed: int = 42, coeff_range: float = 100.0, **_ignored):
        super().__init__(seed=seed)
        self.coeff_range = coeff_range

    async def pre_process(self, device_info: str = "", **kwargs) -> PreparedRun:
        async with self._lock:
            kind = int(self.rng.integers(0, 6))
            a, b, c = self.rng.uniform(-self.coeff_range, self.coeff_range, 3)
        if kind == 0:
            a = 0.0
        elif kind == 1:
            a = b = 0.0
        elif kind == 2:
            a = b = c = 0.0
        a32, b32, c32 = (np.float32(v) for v in (a, b, c))
        text = f"{a32:.6e} {b32:.6e} {c32:.6e}\n"
        # the oracle must see the serialized coefficients
        pa, pb, pc = protocol.parse_hw1(text)
        return PreparedRun(
            stdin_text=text,
            verify_ctx=solve_scalar(pa, pb, pc),
            metadata={"kind": kind},
        )

    async def load_result(self, stdout_payload: str, prepared: PreparedRun) -> Any:
        return stdout_payload.strip()

    async def verify(self, result: Any, prepared: PreparedRun) -> bool:
        return result == prepared.verify_ctx


class Hw2Processor(WorkloadProcessor):
    """Random float vectors; oracle = NumPy ascending sort at %.6e."""


    def __init__(
        self,
        seed: int = 42,
        size_min: int = 64,
        size_max: int = 1024,
        value_range: float = 1e6,
        **_ignored,
    ):
        super().__init__(seed=seed)
        self.size_min = size_min
        self.size_max = size_max
        self.value_range = value_range

    async def pre_process(self, device_info: str = "", **kwargs) -> PreparedRun:
        async with self._lock:
            n = int(self.rng.integers(self.size_min, self.size_max))
            vals = self.rng.uniform(-self.value_range, self.value_range, n).astype(
                np.float32
            )
        text = protocol.format_hw2_input(vals)
        sent = protocol.parse_hw2(text)
        expect = protocol.format_vector_6e(np.sort(sent)).strip()
        return PreparedRun(stdin_text=text, verify_ctx=expect, metadata={"n": n})

    async def load_result(self, stdout_payload: str, prepared: PreparedRun) -> Any:
        return stdout_payload.strip()

    async def verify(self, result: Any, prepared: PreparedRun) -> bool:
        return result == prepared.verify_ctx
