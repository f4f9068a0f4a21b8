"""Experiment orchestrator: sweeps, A/B devices, verification gating, stats.

The L4 layer of the suite (the reference's ``BaseTester``,
``tester.py:169-323``): run a target over the full ``k_times x
kernel_sizes`` grid, run the reference target (CPU) once per repetition
with no launch config, gate aggregation on all runs verifying, write
``stats_*.csv`` / ``failed_*.csv`` / ``runs_*.csv`` artifacts, and render
the median bar chart.

The JAX package builds these tables with pandas; the card's machine has
no pandas, so here a table is a list of row dicts, :func:`summarize`
computes pandas' ``groupby(...).agg`` with numpy (sample standard
deviation, ``ddof=1``, as pandas), and the CSVs are written with
:mod:`csv`.
"""

from __future__ import annotations

import asyncio
import csv
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from tpulab_torch.harness.base import RunRecord, WorkloadProcessor
from tpulab_torch.harness.runner import Target, run_once

STAT_COLUMNS = ["mean", "median", "min", "max", "std"]
GROUP_COLUMNS = ["device", "kernel_size"]


def _is_missing(value) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def summarize(rows: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-(device, kernel_size) timing stats of ``time_kernel_ms``, one row
    a group in sorted key order; missing times are left out of a group's
    statistics and of its ``count``."""
    groups: Dict[tuple, List[float]] = {}
    for row in rows:
        key = tuple(row[c] for c in GROUP_COLUMNS)
        times = groups.setdefault(key, [])
        if not _is_missing(row.get("time_kernel_ms")):
            times.append(float(row["time_kernel_ms"]))
    out = []
    for key in sorted(groups):
        t = np.asarray(groups[key], np.float64)
        nan = float("nan")
        out.append({
            **dict(zip(GROUP_COLUMNS, key)),
            "mean": float(t.mean()) if t.size else nan,
            "median": float(np.median(t)) if t.size else nan,
            "min": float(t.min()) if t.size else nan,
            "max": float(t.max()) if t.size else nan,
            "std": float(t.std(ddof=1)) if t.size > 1 else nan,
            "count": int(t.size),
        })
    return out


def write_csv(path: str, rows: Sequence[Dict[str, Any]]) -> None:
    """Rows to CSV, columns in order of first appearance; a missing value
    is an empty field, as pandas writes it."""
    columns: List[str] = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        writer.writeheader()
        for row in rows:
            writer.writerow({k: "" if _is_missing(row.get(k)) else row.get(k) for k in columns})


def format_table(rows: Sequence[Dict[str, Any]]) -> str:
    """Rows as aligned text columns (the log's stats table)."""
    if not rows:
        return ""
    columns = list(rows[0])
    cells = [columns] + [[f"{r[c]:.6g}" if isinstance(r[c], float) else str(r[c])
                          for c in columns] for r in rows]
    widths = [max(len(line[i]) for line in cells) for i in range(len(columns))]
    return "\n".join(" ".join(v.rjust(w) for v, w in zip(line, widths)) for line in cells)


class Tester:
    """Sweep runner.

    Parameters mirror the reference CLI surface (run_test.py:19-51):
    ``k_times`` repetitions x ``kernel_sizes`` launch configs for the
    accelerated target; the optional CPU-reference target runs ``k_times``
    times with no launch config (tester.py:302-310).
    """

    __test__ = False  # not a pytest collectible despite the name

    def __init__(
        self,
        target: Target,
        *,
        cpu_target: Optional[Target] = None,
        k_times: int = 20,
        kernel_sizes: Optional[Sequence] = None,
        artifact_dir: str = ".",
        metadata_columns2plot: Optional[List[str]] = None,
        max_concurrency: int = 1,
        return_inp: bool = False,
        return_task_res: bool = False,
        log=print,
    ):
        self.target = target
        self.cpu_target = cpu_target
        self.k_times = k_times
        self.kernel_sizes = list(kernel_sizes) if kernel_sizes else [None]
        self.artifact_dir = artifact_dir
        self.metadata_columns2plot = metadata_columns2plot or []
        self.max_concurrency = max(1, max_concurrency)
        #: debug columns (reference run_test.py:44-49): ``return_inp``
        #: adds the raw stdin payload per row, ``return_task_res`` the
        #: parsed task result — both land in the runs/stats CSVs.
        self.return_inp = return_inp
        self.return_task_res = return_task_res
        self.log = log

    async def run_target_sweep(
        self, target: Target, processor: WorkloadProcessor, kernel_sizes: Sequence
    ) -> List[RunRecord]:
        sem = asyncio.Semaphore(self.max_concurrency)

        async def one(ks):
            device_info = f"{target.name}__{ks}"
            async with sem:
                return await run_once(
                    target, processor, ks, device_info=device_info,
                    return_inp=self.return_inp,
                    return_task_res=self.return_task_res,
                )

        tasks = [
            asyncio.create_task(one(ks))
            for _ in range(self.k_times)
            for ks in kernel_sizes
        ]
        return [await t for t in tasks]

    async def run_experiments(self, processor: WorkloadProcessor) -> List[Dict[str, Any]]:
        """Full experiment: accelerated sweep + CPU reference pass.

        Returns the combined run table (one dict a run); artifacts land in
        artifact_dir.
        """
        t_start = time.perf_counter()
        self.log(f"[Experiments] target={self.target.name} k_times={self.k_times} "
                 f"kernel_sizes={self.kernel_sizes}")
        jobs = [self.run_target_sweep(self.target, processor, self.kernel_sizes)]
        if self.cpu_target is not None:
            jobs.append(self.run_target_sweep(self.cpu_target, processor, [None]))
        all_records: List[RunRecord] = []
        for recs in await asyncio.gather(*jobs):
            all_records.extend(recs)

        attrs = processor.get_attrs()
        for r in all_records:
            r.metadata.update(attrs)
        rows = [r.as_row() for r in all_records]

        failed = [r for r in rows if r["verified"] is not True or r["error"] is not None]
        os.makedirs(self.artifact_dir, exist_ok=True)
        if failed:
            path = os.path.join(self.artifact_dir, f"failed_{self.target.name}.csv")
            write_csv(path, failed)
            self.log(f"[Experiments] {len(failed)}/{len(rows)} runs failed verification "
                     f"-> {path}; stats withheld (all-verify gate)")
        else:
            stats = summarize(rows)
            path = os.path.join(self.artifact_dir, f"stats_{self.target.name}.csv")
            write_csv(path, stats)
            self.log(f"[Experiments] stats -> {path}")
            self.log(format_table(stats))
            try:
                from tpulab_torch.harness.plotting import plot_median_times

                png = os.path.join(self.artifact_dir, "median_execution_time.png")
                plot_median_times(rows, png, metadata_columns=self.metadata_columns2plot)
                self.log(f"[Experiments] chart -> {png}")
            except Exception as exc:  # plotting is best-effort (no matplotlib, headless)
                self.log(f"[Experiments] plot skipped: {exc}")
        raw_path = os.path.join(self.artifact_dir, f"runs_{self.target.name}.csv")
        write_csv(raw_path, rows)
        self.log(f"[Experiments] total {time.perf_counter() - t_start:.2f}s, "
                 f"{len(rows)} runs -> {raw_path}")
        return rows
