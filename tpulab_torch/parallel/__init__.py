"""The multi-device tier (the counterpart of ``tpulab.parallel``) and the
attention blocks the model tier shares.

* ``mesh``        — ``DeviceMesh`` over a process group, the rank pool
* ``multihost``   — joining a launched run, the node-major global mesh
* ``collectives`` — lab5's all-reduce, all-gather, reduce-scatter
* ``halo``        — lab2's Roberts cross with a one-row halo
* ``classify``    — lab3 over row shards
* ``dsort``       — hw2's sample sort
* ``ring``        — the dense attention oracle and the flash predicate

Ranks are processes: gloo on the CPU, NCCL on the card with one GPU a
rank.  Ring, zigzag and Ulysses attention, MoE and the pipeline wait for
ROADMAP A12.2; mesh training for A12.3; the tp-sharded engine for A12.4.
"""

from tpulab_torch.parallel.classify import classify_sharded
from tpulab_torch.parallel.collectives import (all_gather_op, distributed_mean,
                                               distributed_reduce, reduce_scatter_op)
from tpulab_torch.parallel.dsort import distributed_sort
from tpulab_torch.parallel.halo import roberts_sharded
from tpulab_torch.parallel.mesh import (RankPool, best_factorization, launch, make_mesh,
                                        mesh_anchor, mesh_devices, parse_mesh_spec)
from tpulab_torch.parallel.multihost import (global_mesh, host_shard_to_global,
                                             initialize as initialize_multihost,
                                             sync_global_devices)

__all__ = [
    "make_mesh",
    "mesh_devices",
    "best_factorization",
    "parse_mesh_spec",
    "mesh_anchor",
    "RankPool",
    "launch",
    "distributed_reduce",
    "distributed_mean",
    "all_gather_op",
    "reduce_scatter_op",
    "roberts_sharded",
    "distributed_sort",
    "classify_sharded",
    "global_mesh",
    "host_shard_to_global",
    "initialize_multihost",
    "sync_global_devices",
]
