"""Harness CLI — the reference's ``run_test.py`` surface over the port.

Examples::

    # in-process CUDA target + CPU reference A/B, lab2 sweep
    python -m tpulab_torch.harness.run --lab lab2 --k-times 5 \
        --kernel-sizes '[[[32,32],[16,16]],[[16,16],[32,32]]]' --cpu-ref

    # drive an external binary speaking the stdin contract (the
    # reference's nvcc-built to_plot binaries work unchanged)
    python -m tpulab_torch.harness.run --binary-path ./lab2/src/to_plot_exe \
        --k-times 20

The in-process target runs on the card unless ``--backend cpu`` asks for
the host; ``--cpu-ref`` adds the same workload with ``backend="cpu"`` as
the reference's CUDA-vs-CPU A/B.  Each kernel wrapper picks the kernel on
the card and its plain version on the CPU, so no ``use_pallas`` knob is
forwarded.

Lab resolution from a binary path follows the reference convention
``labN/src/<exe>`` (run_test.py:58-60); unknown ``--key value`` flags are
coerced and forwarded to the processor constructor (arg_parsing.py
behavior).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from typing import List, Optional

from tpulab_torch.harness.processors import MAP_PROCESSORS
from tpulab_torch.harness.runner import InProcessTarget, SubprocessTarget
from tpulab_torch.harness.tester import Tester
from tpulab_torch.runtime.device import BACKENDS, device_label, resolve_device
from tpulab_torch.utils.argcfg import coerce_cli_kwargs


def infer_lab_from_path(binary_path: str) -> str:
    """``.../labN/src/exe`` -> ``labN`` (reference run_test.py:58-60)."""
    return os.path.basename(os.path.dirname(os.path.dirname(os.path.abspath(binary_path))))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lab", help="workload name (lab1|lab2|lab3|lab5|hw1|hw2)")
    p.add_argument("--binary-path", "--binary_path_cuda", dest="binary_path",
                   help="external binary speaking the stdin contract")
    p.add_argument("--binary-path-cpu", "--binary_path_cpu", dest="binary_path_cpu",
                   help="external CPU reference binary")
    p.add_argument("--binary-args", "--binary_args", dest="binary_args", default=None,
                   help="extra argv for --binary-path, e.g. 'lab2 --to-plot' for the "
                        "native daemon client (env TPULAB_DAEMON_SOCKET selects the daemon)")
    p.add_argument("--cpu-ref", action="store_true",
                   help="run the in-process CPU backend as the A/B reference")
    p.add_argument("--k-times", "--k_times", type=int, default=20)
    p.add_argument("--kernel-sizes", "--kernel_sizes", default=None,
                   help="JSON list of per-lab launch configs")
    p.add_argument("--return-inp", "--return_inp", dest="return_inp",
                   action="store_true",
                   help="record each run's raw stdin payload as a CSV column "
                        "(reference run_test.py:44-45)")
    p.add_argument("--return-task-res", "--return_task_res", dest="return_task_res",
                   action="store_true",
                   help="record each run's parsed task result as a CSV column "
                        "(reference run_test.py:47-49)")
    p.add_argument("--metadata-columns2plot", "--metadata_columns2plot", default="[]")
    p.add_argument("--artifact-dir", "--artifact_dir", dest="artifact_dir", default=None)
    p.add_argument("--backend", default=None, choices=BACKENDS,
                   help="cuda (default) or cpu, for the in-process target")
    args, unknown = p.parse_known_args(argv)
    cfg = coerce_cli_kwargs(unknown)

    lab = args.lab or (infer_lab_from_path(args.binary_path) if args.binary_path else None)
    if lab not in MAP_PROCESSORS:
        p.error(f"cannot resolve workload: --lab or a labN/src/<exe> path required "
                f"(got {lab!r}; known: {sorted(MAP_PROCESSORS)})")

    processor = MAP_PROCESSORS[lab](**cfg)

    kernel_sizes = json.loads(args.kernel_sizes) if args.kernel_sizes else [None]
    sweep = args.kernel_sizes is not None

    if args.binary_path:
        extra_argv = args.binary_args.split() if args.binary_args else []
        target = SubprocessTarget(
            name=os.path.basename(args.binary_path),
            device_label="BIN",
            argv=[args.binary_path, *extra_argv],
        )
        artifact_dir = args.artifact_dir or os.path.dirname(os.path.abspath(args.binary_path))
    else:
        # Workload-run knobs shared between the processor oracle and the
        # in-process target.  Every labs.*.run() swallows unknown kwargs,
        # but keep this an explicit list so processor-only synthesis
        # kwargs (seed, size_min, ...) never leak into the compute path.
        run_keys = ("warmup", "reps", "timing", "op", "dtype", "task", "mesh",
                    "compute_dtype")
        run_cfg = {k: cfg[k] for k in run_keys if k in cfg}
        if lab in ("hw1", "hw2"):
            run_cfg.setdefault("timing", True)
        target = InProcessTarget(
            name=f"tpulab_torch_{lab}",
            device_label=device_label(resolve_device(args.backend)),
            workload=lab,
            sweep=sweep,
            backend=args.backend,
            config=run_cfg,
        )
        artifact_dir = args.artifact_dir or "."

    cpu_target = None
    if args.binary_path_cpu:
        cpu_target = SubprocessTarget(
            name=os.path.basename(args.binary_path_cpu),
            device_label="CPU",
            argv=[args.binary_path_cpu],
        )
    elif args.cpu_ref:
        base_cfg = dict(getattr(target, "config", {}) or {})
        cpu_target = InProcessTarget(
            name=f"tpulab_torch_{lab}_cpu",
            device_label="CPU",
            workload=lab,
            sweep=False,
            backend="cpu",
            config=base_cfg,
        )

    tester = Tester(
        target,
        cpu_target=cpu_target,
        k_times=args.k_times,
        kernel_sizes=kernel_sizes,
        artifact_dir=artifact_dir,
        metadata_columns2plot=json.loads(args.metadata_columns2plot),
        return_inp=args.return_inp,
        return_task_res=args.return_task_res,
    )
    rows = asyncio.run(tester.run_experiments(processor))
    return 0 if all(r["verified"] is True for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
