"""``tpulab_torch`` command-line entry point.

Subcommands:
    tpulab_torch info              device introspection (gpu_info)
    tpulab_torch run <workload>    run a workload over the stdin/stdout protocol
    tpulab_torch generate          sample from the labformer (demo weights or --ckpt-dir)
    tpulab_torch train             train the labformer (flash backward: kernels B5, B6),
                                   with checkpoints, resume, recover and --init-from
    tpulab_torch tokenizer         train / inspect a BPE tokenizer
    tpulab_torch eval              held-out loss, perplexity and bits per byte of a checkpoint
    tpulab_torch distill           compress a checkpoint into a smaller servable student
    tpulab_torch bench             the lab benchmark rows, one JSON line each
    tpulab_torch selftest          one-minute end-to-end sanity check

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
    run_p.add_argument("workload", help="lab1|lab2|lab3|lab5|hw1|hw2|gpu_info")
    run_p.add_argument("--to-plot", action="store_true",
                       help="sweep mode: read the launch geometry from a stdin prefix")
    run_p.add_argument("--backend", default=None, choices=BACKENDS,
                       help="cuda (default) or cpu")

    sub.add_parser("generate", help="sample from the labformer", add_help=False)
    sub.add_parser("train", help="train the labformer (checkpoint/resume)", add_help=False)
    sub.add_parser("tokenizer", help="train/inspect a BPE tokenizer", add_help=False)
    sub.add_parser("eval", help="held-out loss/perplexity/bits-per-byte of a checkpoint",
                   add_help=False)
    sub.add_parser("distill", help="compress a checkpoint into a smaller servable student "
                                   "(soft-target KL)", add_help=False)
    sub.add_parser("bench", help="run the lab benchmarks", add_help=False)
    sub.add_parser("selftest", help="one-minute end-to-end sanity check", add_help=False)

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

    if args.command == "generate":
        from tpulab_torch.models.generate import main as gen_main

        return gen_main(extra)

    if args.command == "train":
        from tpulab_torch.train import main as train_main

        return train_main(extra)

    if args.command == "tokenizer":
        from tpulab_torch.io.bpe import main as tok_main

        return tok_main(extra)

    if args.command == "eval":
        from tpulab_torch.evaluate import main as eval_main

        return eval_main(extra)

    if args.command == "distill":
        from tpulab_torch.models.distill import main as distill_main

        return distill_main(extra)

    if args.command == "bench":
        from tpulab_torch.cli.bench import run_bench_cli

        return run_bench_cli(extra)

    if args.command == "selftest":
        from tpulab_torch.selftest import main as selftest_main

        return selftest_main(extra)

    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
