"""Run targets: subprocess binaries and in-process workload modules.

The subprocess target preserves the reference's process-per-run contract
(reference ``tester.py:94-166``: spawn binary, feed stdin, parse the
timing line from stdout line 1).  The in-process target runs a
:mod:`tpulab_torch.labs` workload directly — same stdin/stdout text
contract, with the CUDA context and the built kernels kept warm across
runs.  Its backend is the card unless it is given ``backend="cpu"``.
"""

from __future__ import annotations

import asyncio
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpulab_torch.harness.base import PreparedRun, RunRecord, WorkloadProcessor
from tpulab_torch.runtime.timing import parse_timing_device, parse_timing_line


@dataclass
class Target:
    """Something that can execute one stdin->stdout run."""

    name: str = "target"
    device_label: str = "CUDA"

    async def execute(self, stdin_text: str, sweep: bool | None = None) -> str:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass
class SubprocessTarget(Target):
    """Spawn ``argv`` per run, exactly like the reference harness spawns
    the nvcc-built binaries (tester.py:126-132)."""

    argv: List[str] = field(default_factory=list)

    async def execute(self, stdin_text: str, sweep: bool | None = None) -> str:
        del sweep  # binaries learn the config from the stdin prefix itself
        proc = await asyncio.create_subprocess_exec(
            *self.argv,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        stdout, stderr = await proc.communicate(stdin_text.encode())
        if proc.returncode != 0:
            raise RuntimeError(
                f"{self.argv[0]} exited {proc.returncode}: {stderr.decode(errors='replace')[-2000:]}"
            )
        return stdout.decode(errors="replace")


@dataclass
class InProcessTarget(Target):
    """Run a tpulab_torch workload module in this process."""

    workload: str = "lab1"
    sweep: bool = False
    backend: Optional[str] = None
    config: Dict[str, Any] = field(default_factory=dict)

    async def execute(self, stdin_text: str, sweep: bool | None = None) -> str:
        from tpulab_torch.labs import get_workload

        mod = get_workload(self.workload)
        # Per-run override: a None kernel_sizes entry serializes to no
        # prefix lines, so the workload must not parse one even when the
        # overall experiment is a sweep (and vice versa).
        effective_sweep = self.sweep if sweep is None else sweep
        return await asyncio.to_thread(
            mod.run, stdin_text, sweep=effective_sweep, backend=self.backend, **self.config
        )


async def run_once(
    target: Target,
    processor: WorkloadProcessor,
    kernel_size=None,
    device_info: str = "",
    return_inp: bool = False,
    return_task_res: bool = False,
) -> RunRecord:
    """Execute one run end-to-end: pre_process -> target -> parse -> verify.

    Failures of any stage are captured into the record (the reference's
    blanket except -> failed-row behavior, tester.py:144-166), never raised.
    ``return_inp`` stashes the full stdin payload in the row (reference
    tester.py:123-124: ``debug_data["input_str"]``); ``return_task_res``
    keeps the parsed task result as a row column (reference
    tester.py:254-258 drops it from the CSV unless the flag is set).
    """
    record = RunRecord(
        bin_name=target.name,
        device=target.device_label,
        kernel_size=str(kernel_size),
    )
    t0 = time.perf_counter()
    prepared: Optional[PreparedRun] = None
    try:
        prepared = await processor.pre_process(device_info=device_info)
        record.metadata.update(prepared.metadata)
        prefix = processor.serialize_kernel_size(kernel_size)
        if return_inp:
            record.metadata["input_str"] = prefix + prepared.stdin_text
        stdout = await target.execute(prefix + prepared.stdin_text, sweep=bool(prefix))
        first, _, payload = stdout.partition("\n")
        record.time_kernel_ms = parse_timing_line(first)
        if record.time_kernel_ms is None:
            payload = stdout  # no timing line (reference hw binaries)
        else:
            # The nominal target label groups the A/B sweeps; the timing
            # line's device word records which backend actually executed
            # (hw1 solves on the host under any target) so charts and
            # stats can expose misattribution.
            record.device_reported = parse_timing_device(first)
        result = await processor.load_result(payload, prepared)
        if return_task_res:
            record.metadata["task_result"] = result
        record.verified = await processor.verify(result, prepared)
    except Exception:
        record.error = traceback.format_exc(limit=8)
        record.verified = False
    record.time_wall_ms = (time.perf_counter() - t0) * 1e3
    return record
