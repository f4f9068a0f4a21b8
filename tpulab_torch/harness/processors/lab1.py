"""lab1 processor: synthetic double vectors + NumPy oracle verification.

Reference behavior (lab1/lab1_processor.py): vectors of size ~U[1024, 3072)
with values U[-1e100, 1e100], serialized at precision 10; the intended
oracle ``allclose(result, a - b)`` was committed commented-out
(lab1_processor.py:62-66) — here it is **active**, computed against the
round-tripped (serialized-then-parsed) inputs so serialization
quantization is not misattributed to the kernel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpulab_torch.harness.base import PreparedRun, WorkloadProcessor
from tpulab_torch.io import protocol


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16, back as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


class Lab1Processor(WorkloadProcessor):

    def __init__(
        self,
        seed: int = 42,
        size_min: int = 1024,
        size_max: int = 3072,
        value_range: float = 1e100,
        rtol: float = 1e-9,
        op: str = "subtract",
        dtype: str = "float64",
        **_ignored,
    ):
        super().__init__(seed=seed)
        self.size_min = size_min
        self.size_max = size_max
        self.dtype = dtype
        # the reference's [-1e100, 1e100] range (lab1_processor.py:30-36)
        # overflows narrow compute dtypes to inf; keep synthesis inside
        # the representable range so a-b stays finite
        if dtype != "float64" and value_range > 1e30:
            value_range = 1e30
        self.value_range = value_range
        self.rtol = rtol
        self.op = op
        self._np_op = {
            "subtract": np.subtract,
            "add": np.add,
            "multiply": np.multiply,
        }[op]

    def get_attrs(self):
        return {
            "seed": self.seed,
            "op": self.op,
            "dtype": self.dtype,
            "value_range": self.value_range,
        }

    async def pre_process(self, device_info: str = "", **kwargs) -> PreparedRun:
        async with self._lock:
            n = int(self.rng.integers(self.size_min, self.size_max))
            a = self.rng.uniform(-self.value_range, self.value_range, n)
            b = self.rng.uniform(-self.value_range, self.value_range, n)
        text = protocol.format_lab1_input(a, b)
        sent = protocol.parse_lab1(text)  # the oracle sees what the target sees
        return PreparedRun(
            stdin_text=text,
            verify_ctx=self._oracle(sent.a, sent.b),
            metadata={"n": n},
        )

    def _oracle(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Mirror the workload's compute dtype exactly (labs/lab1.py:52-55):
        inputs are rounded to the compute dtype before the op, and for
        bfloat16 the f32 op result is rounded back to bf16 — the f32 op on
        bf16-rounded inputs is exact, so rounding after equals computing
        in bf16.  bfloat16 rounds through torch, to nearest even as the
        JAX package's ``ml_dtypes`` does."""
        if self.dtype == "float64":
            return self._np_op(a, b)
        a32, b32 = a.astype(np.float32), b.astype(np.float32)
        if self.dtype == "bfloat16":
            a32, b32 = _bf16_round(a32), _bf16_round(b32)
            return _bf16_round(self._np_op(a32, b32)).astype(np.float64)
        return self._np_op(a32, b32).astype(np.float64)

    async def load_result(self, stdout_payload: str, prepared: PreparedRun) -> Any:
        return np.array([float(t) for t in stdout_payload.split()], np.float64)

    async def verify(self, result: Any, prepared: PreparedRun) -> bool:
        expect = prepared.verify_ctx
        return result.shape == expect.shape and bool(
            np.allclose(result, expect, rtol=self.rtol, atol=1e-10)
        )
