"""Collectives over a mesh axis: lab5's reduction as an all-reduce, and the
gather and reduce-scatter wrappers (the counterpart of
``tpulab.parallel.collectives``).

Each function runs on every rank of the mesh with the same full host
array: the array is widened and padded on the host as ``tpulab`` stages
it, each rank takes its shard of the axis onto its own device, and every
rank gets the same full result.

The reduction reduces each shard with the single-device reduction
(:func:`tpulab_torch.ops.reduction.reduce_values`) and combines the
partials by gathering them all and reducing them again, in rank order
(``tpulab`` combines a product so, through ``all_gather``, for want of a
``pprod``).  That is one ``all_gather_into_tensor`` of a scalar a rank,
which gloo and NCCL both carry for every dtype lab5 reduces (int64 after
the widening, float32, float64), and it gives every rank the
single-device reduction's answer, the same bits on each: gloo's MIN and
MAX (probed on two ranks) keep a NaN only from the first rank and return
the first rank's zero whatever its sign, where the single-device
reduction propagates NaN and orders -0.0 below +0.0; and a collective
sum or product combines in an order of its own.  :func:`distributed_mean` sums with
``all_reduce``.  A collective on a dtype its group's backend does not
carry is refused by name (:func:`check_dtype`) before it is posted.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpulab_torch.ops.reduction import REDUCERS, reduce_values
from tpulab_torch.parallel.mesh import axis_mesh, axis_size, mesh_anchor

#: the dtypes each backend's collectives carry (gloo: ``ProcessGroupGloo``'s
#: types, checked by a probe over every collective used here; NCCL: its
#: ``ncclDataType_t``, to which PyTorch also maps bool).  Neither has int16.
BACKEND_DTYPES = {
    "gloo": {torch.bool, torch.uint8, torch.int8, torch.int32, torch.int64, torch.float16,
             torch.bfloat16, torch.float32, torch.float64},
    "nccl": {torch.bool, torch.uint8, torch.int8, torch.int32, torch.int64, torch.uint32,
             torch.uint64, torch.float16, torch.bfloat16, torch.float32, torch.float64},
}

_IDENTITY = {"sum": 0, "prod": 1, "min": None, "max": None}  # None -> edge value
_NARROW = (np.dtype(np.uint8), np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32))


def to_host(values) -> np.ndarray:
    """``values`` (a tensor on any device, or array-like) as host numpy."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def pad_to_multiple(x: np.ndarray, m: int, fill) -> np.ndarray:
    """Pad ``x`` along its first axis with ``fill`` to a multiple of ``m``."""
    pad = (-x.shape[0]) % m
    if pad == 0:
        return x
    return np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)])


def shard_of(x: np.ndarray, mesh, axis: str) -> torch.Tensor:
    """This rank's block of ``x``'s first axis (a multiple of the axis
    size), on this rank's device."""
    p, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    m = x.shape[0] // p
    return torch.from_numpy(np.ascontiguousarray(x[r * m:(r + 1) * m])).to(mesh_anchor(mesh))


def check_dtype(dtype: torch.dtype, group, what: str) -> None:
    """Refuse a collective on ``dtype`` that ``group``'s backend lacks."""
    backend = str(dist.get_backend(group))
    if dtype not in BACKEND_DTYPES.get(backend, ()):
        have = sorted(str(d).replace("torch.", "") for d in BACKEND_DTYPES.get(backend, ()))
        raise TypeError(f"{what}: the {backend} backend has no collectives on {dtype} "
                        f"(it has {', '.join(have)})")


def gather_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` of the axis, concatenated along the first dim in
    rank order (``all_gather_into_tensor``)."""
    group = mesh.get_group(axis)
    check_dtype(x.dtype, group, "all_gather")
    x = x.contiguous()
    out = torch.empty((axis_size(mesh, axis) * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _identity_fill(op: str, dtype: np.dtype) -> np.ndarray:
    if _IDENTITY[op] is not None:
        return np.asarray(_IDENTITY[op], dtype)
    info = np.finfo(dtype) if np.issubdtype(dtype, np.floating) else np.iinfo(dtype)
    return np.asarray(info.max if op == "min" else info.min, dtype)


def widen_and_pad(values, op: str, parts: int) -> np.ndarray:
    """``values`` on the host as the reduction stages them for ``parts``
    shards: integers narrower than 64 bits widened to int64 (as ``tpulab``
    under x64), then padded with ``op``'s identity to a multiple of
    ``parts``."""
    x = to_host(values)
    if x.dtype in _NARROW:
        x = x.astype(np.int64)
    return pad_to_multiple(x, parts, _identity_fill(op, x.dtype))


def stage_reduce(values, op: str = "sum", *, mesh, axis: str = "x") -> torch.Tensor:
    """This rank's shard of :func:`widen_and_pad`, on its device: what
    :func:`reduce_staged` reduces."""
    return shard_of(widen_and_pad(values, op, axis_size(mesh, axis)), mesh, axis)


def reduce_staged(x: torch.Tensor, *, op: str, mesh, axis: str) -> torch.Tensor:
    """All-reduce of a staged shard: the shard reduced, the partials
    gathered and reduced in rank order; a 0-d tensor, the same on every
    rank."""
    return reduce_values(gather_axis(reduce_values(x, op).reshape(1), mesh, axis), op)


def distributed_reduce(values, op: str = "sum", *, mesh=None, axis: str = "x",
                       num_devices: Optional[int] = None,
                       backend: Optional[str] = None) -> torch.Tensor:
    """All-reduce a 1-D array sharded over ``mesh[axis]`` (``sum``,
    ``min``, ``max`` or ``prod``).  ``num_devices``/``backend`` shape the
    mesh made when ``mesh`` is None (every rank of the group)."""
    if op not in REDUCERS:
        raise ValueError(f"unknown reduction {op!r}; have {sorted(REDUCERS)}")
    mesh = axis_mesh(mesh, axis, num_devices, backend)
    return reduce_staged(stage_reduce(values, op, mesh=mesh, axis=axis), op=op, mesh=mesh,
                         axis=axis)


def distributed_mean(values, *, mesh=None, axis: str = "x",
                     num_devices: Optional[int] = None) -> torch.Tensor:
    """Mean: the zero-padded shards' sums all-reduced, over the true count
    (integers as float64)."""
    mesh = axis_mesh(mesh, axis, num_devices)
    x = to_host(values)
    if x.dtype.kind not in "fc":
        x = x.astype(np.float64)
    n_true = x.shape[0]
    shard = shard_of(pad_to_multiple(x, axis_size(mesh, axis), np.asarray(0, x.dtype)),
                     mesh, axis)
    total = shard.sum()
    group = mesh.get_group(axis)
    check_dtype(total.dtype, group, "all_reduce")
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / torch.tensor(n_true, dtype=total.dtype, device=total.device)


def all_gather_op(values, *, mesh=None, axis: str = "x") -> torch.Tensor:
    """Gather a 1-D array sharded over ``mesh[axis]`` to every rank."""
    mesh = axis_mesh(mesh, axis)
    x = to_host(values)
    if x.shape[0] % axis_size(mesh, axis):
        raise ValueError(f"length {x.shape[0]} not divisible by mesh axis "
                         f"{axis_size(mesh, axis)}")
    return gather_axis(shard_of(x, mesh, axis), mesh, axis)


def reduce_scatter_op(matrix, *, mesh=None, axis: str = "x") -> torch.Tensor:
    """Row-wise reduce-scatter: rank ``i`` holds row ``i`` of a ``(k, n)``
    matrix and gets its ``n/k`` columns of the column sum
    (``reduce_scatter_tensor``); the result is those blocks gathered, the
    whole column sum, as ``tpulab``'s sharded array reads."""
    mesh = axis_mesh(mesh, axis)
    x = to_host(matrix)
    k = axis_size(mesh, axis)
    if x.ndim != 2 or x.shape[0] != k or x.shape[1] % k:
        raise ValueError(f"expected ({k}, m*{k}) matrix, got {x.shape}")
    row = shard_of(x, mesh, axis)[0]
    group = mesh.get_group(axis)
    check_dtype(row.dtype, group, "reduce_scatter")
    block = torch.empty(x.shape[1] // k, dtype=row.dtype, device=row.device)
    dist.reduce_scatter_tensor(block, row, op=dist.ReduceOp.SUM, group=group)
    return gather_axis(block, mesh, axis)
