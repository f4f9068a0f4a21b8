"""``tpulab_torch`` command-line entry point.

Subcommands:
    tpulab_torch info              device introspection (gpu_info)
    tpulab_torch run <workload>    run a workload over the stdin/stdout protocol

``python -m tpulab_torch`` routes here as well.  Work runs on the CUDA
card unless ``--backend cpu`` asks for the host.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from tpulab_torch.runtime.device import BACKENDS


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpulab_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command")

    info_p = sub.add_parser("info", help="print device information")
    info_p.add_argument("--backend", default=None, choices=BACKENDS)

    run_p = sub.add_parser("run", help="run a workload (stdin/stdout protocol)")
    run_p.add_argument("workload", help="lab1|lab2|lab3|gpu_info")
    run_p.add_argument("--to-plot", action="store_true",
                       help="sweep mode: read the launch geometry from a stdin prefix")
    run_p.add_argument("--backend", default=None, choices=BACKENDS,
                       help="cuda (default) or cpu")

    args, extra = parser.parse_known_args(argv)

    if args.command == "info":
        from tpulab_torch.labs.gpu_info import run as info_run

        sys.stdout.write(info_run(backend=args.backend))
        return 0

    if args.command == "run":
        from tpulab_torch.labs import run_workload

        return run_workload(
            args.workload, sweep=args.to_plot, backend=args.backend, extra=extra
        )

    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
