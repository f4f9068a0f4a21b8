"""The experiment harness: the reference's ``run_test.py`` surface over the
port's workloads (sweeps, the CPU A/B reference, golden verification,
timing statistics)."""

from tpulab_torch.harness.base import RunRecord, WorkloadProcessor
from tpulab_torch.harness.runner import InProcessTarget, SubprocessTarget, Target, run_once
from tpulab_torch.harness.tester import Tester

__all__ = [
    "InProcessTarget",
    "RunRecord",
    "SubprocessTarget",
    "Target",
    "Tester",
    "WorkloadProcessor",
    "run_once",
]
