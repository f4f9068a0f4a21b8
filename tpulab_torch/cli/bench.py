"""``tpulab_torch bench`` — run the lab benchmarks and print one JSON row each."""

from __future__ import annotations

import json
from typing import List


def run_bench_cli(extra: List[str]) -> int:
    from tpulab_torch.bench import run_benchmarks
    from tpulab_torch.utils.argcfg import coerce_cli_kwargs

    for row in run_benchmarks(**coerce_cli_kwargs(extra or [])):
        print(json.dumps(row), flush=True)
    return 0
