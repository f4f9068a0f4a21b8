"""lab5 processor: typed binary arrays + reduction/sort oracles.

Drives the lab5 workload (tpulab_torch.labs.lab5): serializes an input file in
the ``int32 count + payload`` format, requests a reduction (or sort) and
verifies against the NumPy oracle.  Covers the reference's three element
types (int32 / float32 / uint8, per the lab5/data fixtures).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np

from tpulab_torch.harness.base import PreparedRun, WorkloadProcessor
from tpulab_torch.io import load_typed_array, save_typed_array

_DTYPES = {
    "int": np.int32,
    "float": np.float32,
    "uchar": np.uint8,
}


class Lab5Processor(WorkloadProcessor):

    def __init__(
        self,
        seed: int = 42,
        task: str = "sum",
        elem_type: str = "int",
        size_min: int = 256,
        size_max: int = 4096,
        workdir: str | None = None,
        **_ignored,
    ):
        super().__init__(seed=seed)
        if elem_type not in _DTYPES:
            raise ValueError(f"elem_type must be one of {sorted(_DTYPES)}")
        self.task = task
        self.elem_type = elem_type
        self.size_min = size_min
        self.size_max = size_max
        self.workdir = workdir or tempfile.mkdtemp(prefix="tpulab_lab5_")
        os.makedirs(self.workdir, exist_ok=True)
        self._counter = 0

    def get_attrs(self):
        return {"seed": self.seed, "task": self.task, "elem_type": self.elem_type}

    def _synth(self, n: int) -> np.ndarray:
        dt = _DTYPES[self.elem_type]
        if self.elem_type == "float":
            return self.rng.normal(scale=100.0, size=n).astype(dt)
        if self.elem_type == "uchar":
            return self.rng.integers(0, 256, size=n).astype(dt)
        return self.rng.integers(-10000, 10000, size=n).astype(dt)

    async def pre_process(self, device_info: str = "", **kwargs) -> PreparedRun:
        async with self._lock:
            n = int(self.rng.integers(self.size_min, self.size_max))
            values = self._synth(n)
            idx = self._counter
            self._counter += 1
        in_path = os.path.join(self.workdir, f"{self.elem_type}{n}_{idx}")
        save_typed_array(in_path, values)
        if self.task == "sort":
            out_path = in_path + "_sorted"
            text = f"{in_path}\n{out_path}\n"
            expect = np.sort(values)
            ctx = {"out_path": out_path, "expect": expect}
        else:
            text = f"{in_path}\n"
            oracle = {"sum": np.sum, "min": np.min, "max": np.max, "prod": np.prod}[
                self.task
            ]
            if values.dtype == np.float32:
                expect = oracle(values)
            else:
                # the port widens every integer to int64 before it reduces
                # (tpulab_torch/ops/reduction.py), as the JAX package does
                # with x64 on, which it always turns on
                expect = oracle(values.astype(np.int64))
            ctx = {"out_path": None, "expect": expect}
        return PreparedRun(stdin_text=text, verify_ctx=ctx, metadata={"n": n})

    async def load_result(self, stdout_payload: str, prepared: PreparedRun) -> Any:
        ctx = prepared.verify_ctx
        if ctx["out_path"] is not None:
            return load_typed_array(ctx["out_path"])
        return stdout_payload.strip()

    async def verify(self, result: Any, prepared: PreparedRun) -> bool:
        ctx = prepared.verify_ctx
        expect = ctx["expect"]
        if ctx["out_path"] is not None:
            return bool(np.array_equal(result, expect))
        if isinstance(expect, np.floating) or (
            hasattr(expect, "dtype") and np.issubdtype(expect.dtype, np.floating)
        ):
            return bool(np.isclose(float(result), float(expect), rtol=1e-5))
        return result == str(int(expect))
