"""lab5 — reductions and sorting over the typed binary data format.

The reference's lab5 has **data fixtures only** (``lab5/data/{int10,
float10,uchar10}``: int32 count header + payload) and no committed source;
the contract is the JAX package's (``tpulab/labs/lab5.py``):

stdin: ``input_path [output_path]`` (+ optional ``tile`` sweep prefix int).
Config ``--task sum|min|max|prod|sort`` (default ``sum``).  Reductions
print the timing line then the scalar result; ``sort`` writes the sorted
array to ``output_path`` in the same typed format and prints the timing
line.  ``--mesh N`` runs the multi-device tier where, as in the JAX
package, ``N > 1`` and at least ``N`` devices of the backend are visible:
``N`` ranks (:class:`~tpulab_torch.parallel.mesh.RankPool`: NCCL on the
card, one GPU a rank; gloo on the CPU) reduce with
:func:`~tpulab_torch.parallel.collectives.reduce_staged` or sort with
:func:`~tpulab_torch.parallel.dsort.sample_sort_staged`, and the timing
line is rank 0's bracket after a barrier.  Elsewhere the single-device
path runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpulab_torch.io import load_typed_array, save_typed_array
from tpulab_torch.io.protocol import TokenReader
from tpulab_torch.ops.reduction import REDUCERS, reduce_values
from tpulab_torch.ops.sortops import sort_ascending
from tpulab_torch.runtime.device import device_count, device_label, resolve_device
from tpulab_torch.runtime.timing import format_timing_line, measure_kernel_ms


def _format_scalar(value: np.ndarray) -> str:
    if np.issubdtype(value.dtype, np.integer):
        return str(int(value))
    return f"{float(value):.6e}"


def _mesh_rank(values: np.ndarray, task: str, warmup: int, reps: int):
    """One rank of ``--mesh``: stage (outside the timed window), meet the
    other ranks, time the collective; ``(ms, result)``, rank 0's read."""
    import torch.distributed as dist

    from tpulab_torch.parallel import collectives, dsort
    from tpulab_torch.parallel.mesh import make_mesh, mesh_anchor

    m = make_mesh(axes=("x",))
    if task == "sort":
        staged, meta = dsort.stage_sort(values, mesh=m)
        fn = lambda v: dsort.sample_sort_staged(v, mesh=m, axis="x")  # noqa: E731
    else:
        staged = collectives.stage_reduce(values, task, mesh=m)
        fn = lambda v: collectives.reduce_staged(v, op=task, mesh=m, axis="x")  # noqa: E731
    dist.barrier()
    ms, out = measure_kernel_ms(fn, (staged,), device=mesh_anchor(m), iters=reps,
                                warmup=warmup)
    return ms, (dsort.finish_sort(*out, meta) if task == "sort" else out.cpu().numpy())


def run(
    text: str,
    sweep: bool = False,
    backend: Optional[str] = None,
    *,
    task: str = "sum",
    mesh: int = 0,
    warmup: int = 2,
    reps: int = 5,
    **_ignored,
) -> str:
    if task != "sort" and task not in REDUCERS:
        raise ValueError(f"unknown task {task!r}; have {sorted(REDUCERS) + ['sort']}")
    r = TokenReader(text)
    if sweep:
        r.read_int()  # tile-config slot, reserved
    input_path = r.read_str()
    values = load_typed_array(input_path)
    device = resolve_device(backend)
    if mesh and device_count(device) >= mesh > 1:
        from tpulab_torch.parallel.mesh import launch

        ms, out = launch(_mesh_rank, mesh, values, task, warmup, reps,
                         device_type=device.type)
        line = format_timing_line(device_label(device), ms) + "\n"
        if task == "sort":
            save_typed_array(r.read_str(), out.astype(values.dtype))
            return line
        return line + _format_scalar(out) + "\n"

    # staged once, outside the bracket: the timing measures the reduction
    # or the sort alone, as CUDA events bracket the kernel in the reference
    x = torch.from_numpy(values).to(device)
    fn = sort_ascending if task == "sort" else (lambda v: reduce_values(v, task))
    ms, out = measure_kernel_ms(fn, (x,), device=device, iters=reps, warmup=warmup)
    line = format_timing_line(device_label(device), ms) + "\n"
    if task == "sort":
        save_typed_array(r.read_str(), out.cpu().numpy().astype(values.dtype))
        return line
    return line + _format_scalar(out.cpu().numpy()) + "\n"
