"""Joining a multi-process run (the counterpart of
``tpulab.parallel.multihost``).

:func:`initialize` is ``torch.distributed.init_process_group`` from the
launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` sets them) or from explicit arguments;
outside such a launch it does nothing and returns False, as ``tpulab``'s
does, so single-process code runs unchanged.

The port runs one rank a device, so where ``tpulab`` counts processes
(hosts) and each host's devices, the port counts nodes (``world //
LOCAL_WORLD_SIZE``) and each node's ranks (``LOCAL_WORLD_SIZE``, 1 when
the launcher sets none).  Ranks are numbered node-major, so
:func:`global_mesh` puts the node count on the leading axis and factors
the inner axes from one node's ranks: only the leading (``dp``) axis
crosses nodes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpulab_torch.parallel.mesh import (BACKEND_OF, COLLECTIVE_TIMEOUT, best_factorization,
                                        make_mesh)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> bool:
    """Join the process group; True if this process is (now) in one.

    ``coordinator_address`` (``host:port``, default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` (``WORLD_SIZE``) and ``process_id``
    (``RANK``).  Ranks on the card take NCCL and ``cuda:<local_device_ids[0]>``
    (default ``LOCAL_RANK``); on a host without a card, gloo.  The group of
    one an unlaunched mesh made for this process (``mesh.ensure_group``) is
    no launch: False, as without it."""
    from tpulab_torch.parallel import mesh

    if dist.is_initialized():
        return mesh._IMPLICIT_GROUP is None
    env = os.environ
    if not coordinator_address and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if not coordinator_address:
        return False
    world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cuda":
        local = local_device_ids[0] if local_device_ids else int(env.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
    dist.init_process_group(BACKEND_OF[kind], init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT)
    return True


def runtime_info() -> Dict[str, int]:
    """Node and rank counts of the run (one rank a device)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return {
        "process_index": rank // local,
        "process_count": max(1, world // local),
        "local_device_count": local,
        "global_device_count": world,
    }


def global_mesh(axes: Sequence[str] = ("dp", "sp", "tp", "pp"),
                axis_sizes: Optional[Dict[str, int]] = None, *, backend: Optional[str] = None):
    """A mesh over every rank of every node, the node count on the leading
    axis and the inner axes factored from one node's ranks."""
    if axis_sizes is None:
        info = runtime_info()
        inner = best_factorization(info["local_device_count"], axes[1:]) if len(axes) > 1 else {}
        axis_sizes = {axes[0]: info["process_count"], **{a: inner[a] for a in axes[1:]}}
    return make_mesh({a: axis_sizes[a] for a in axes}, backend=backend)


def host_shard_to_global(local_data, mesh, spec) -> torch.Tensor:
    """The global array from each node's rows: ``spec`` (a tuple of axis
    names or None a dimension, as a ``PartitionSpec`` reads) names the axis
    the first dimension shards over; each node's rows are gathered over it
    in rank order.  With one node (or a replicated first dimension), the
    local rows are the global array."""
    from tpulab_torch.parallel.collectives import gather_axis, to_host
    from tpulab_torch.parallel.mesh import mesh_anchor

    x = torch.from_numpy(np.ascontiguousarray(to_host(local_data))).to(mesh_anchor(mesh))
    axis = spec[0] if len(spec) else None
    return x if axis is None else gather_axis(x, mesh, axis)


def sync_global_devices(tag: str = "tpulab") -> None:
    """Barrier across every rank (nothing with one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
