"""How far the overhead rows' gate moves with the host alone.

Runs each 1 % overhead row of :mod:`tpulab_torch.bench`, and the fault row
with both sides disabled (an A/A pair: the same work on both sides), for
all 5 rounds of :func:`~tpulab_torch.bench._best_of_reps` with no early
stop, and prints one JSON line a run (after one line of what a guarded
fault site costs): the overhead over the pairs so far after every
round, by the gate's estimate (:func:`~tpulab_torch.bench._step_overhead`)
and by the sum of each step's least over the pairs (the estimate it
replaced).  An A/A run's
spread is the gate's noise floor; a row's real tax is read against it.

    python -m tpulab_torch.bench_gate_noise [--repeat 2] [--backend cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from tpulab_torch import bench

ROWS = ("fault_overhead", "journal_overhead", "autoscale_overhead", "spill_overhead")


def least_overhead(on: list, off: list) -> float:
    """The sum of each step's least over the pairs, "on" over "off"."""
    return float(np.min(on, axis=0).sum() / np.min(off, axis=0).sum() - 1.0)


@contextlib.contextmanager
def recording(out: Dict[str, List[float]], aa: bool) -> Iterator[None]:
    """Swap the gate for one that runs every round and records both
    estimates after each; ``aa`` disables the fault row's "on" side."""
    gate, fault_steps = bench._best_of_reps, bench._fault_steps

    def every_round(pair, reps: int, budget: float) -> tuple:
        steps: Dict[bool, list] = {False: [], True: []}
        for _ in range(5):
            for i in range(max(reps, 3)):
                gc.collect()
                gc.disable()
                try:
                    got = pair(i % 2 == 1)
                finally:
                    gc.enable()
                for on in (False, True):
                    steps[on].append(got[on])
            out["paired_median"].append(bench._step_overhead(steps[True], steps[False])[0])
            out["least"].append(least_overhead(steps[True], steps[False]))
        return {on: [sum(x) for x in steps[on]] for on in (False, True)}, out["paired_median"][-1]

    bench._best_of_reps = every_round
    if aa:
        bench._fault_steps = lambda eng, n, active: fault_steps(eng, n, False)
    try:
        yield
    finally:
        bench._best_of_reps, bench._fault_steps = gate, fault_steps


def fire_us(calls: int = 200_000) -> Dict[str, float]:
    """Microseconds a guarded fault site costs with the injector disabled
    and enabled on a schedule that never matches (the fault row's sides)."""
    from tpulab_torch import faults

    out = {}
    for on in (False, True):
        if on:
            faults.configure([{"site": "bench.never", "kind": "raise", "at": 1}])
        t0 = time.perf_counter()
        for _ in range(calls):
            if faults.ACTIVE:
                faults.fire("paged.step", None)
        out["enabled" if on else "disabled"] = (time.perf_counter() - t0) / calls * 1e6
        faults.disable()
    return out


def run(rows=ROWS, repeat: int = 2, backend: Optional[str] = None, **sizes) -> Iterator[dict]:
    """One line a run, the A/A run first in each repeat."""
    plan = [("fault_overhead", True)] + [(row, False) for row in rows]
    for _ in range(repeat):
        for row, aa in plan:
            got: Dict[str, List[float]] = {"paired_median": [], "least": []}
            with recording(got, aa):
                (line,) = bench.run_benchmarks(only=row, backend=backend, **sizes)
            yield {"row": row, "aa": aa,
                   **{f"{k}_pct_by_round": [round(v * 100, 3) for v in got[k]] for k in got},
                   **{k: line[k] for k in ("card", "power_limit", "device") if k in line}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--slots", type=int, default=None)
    args = ap.parse_args(argv)
    sizes = {k: v for k, v in (("steps", args.steps), ("slots", args.slots)) if v is not None}
    print(json.dumps({"fire_us": fire_us()}), flush=True)
    for line in run(repeat=args.repeat, backend=args.backend, **sizes):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
