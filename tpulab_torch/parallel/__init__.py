"""The multi-device tier (the counterpart of ``tpulab.parallel``) and the
attention blocks the model tier shares.

* ``mesh``        — ``DeviceMesh`` over a process group, the rank pool
* ``multihost``   — joining a launched run, the node-major global mesh
* ``collectives`` — lab5's all-reduce, all-gather, reduce-scatter
* ``halo``        — lab2's Roberts cross with a one-row halo
* ``classify``    — lab3 over row shards
* ``dsort``       — hw2's sample sort
* ``spmd``        — differentiable exchanges: shard, gather, ring shift,
                    all-to-all, and the mesh trainer's Megatron pair
                    (``copy_to``, ``reduce_from``), ``gather_shards``
                    and ``repartition``
* ``ring``        — ring, zigzag and Ulysses attention (sequence
                    parallelism), the dense oracle, the flash predicate
* ``moe``         — top-k MoE with all-to-all expert dispatch
* ``pipeline``    — GPipe over a ``pp`` axis, and its training step

Ranks are processes: gloo on the CPU, NCCL on the card with one GPU a
rank.  Mesh training over these blocks is ``tpulab_torch.models.sharded``
(``train(mesh_devices=N)``); the tp-sharded ``PagedEngine`` serves over
``mesh.serving_mesh`` (``mesh.run_on_mesh`` drives it in every rank).
"""

from tpulab_torch.parallel.classify import classify_sharded
from tpulab_torch.parallel.collectives import (all_gather_op, distributed_mean,
                                               distributed_reduce, reduce_scatter_op)
from tpulab_torch.parallel.dsort import distributed_sort
from tpulab_torch.parallel.halo import roberts_sharded
from tpulab_torch.parallel.mesh import (RankPool, best_factorization, launch, make_mesh,
                                        mesh_anchor, mesh_devices, parse_mesh_spec,
                                        run_on_mesh, serving_mesh, shared_pool)
from tpulab_torch.parallel.moe import switch_moe, switch_moe_reference
from tpulab_torch.parallel.multihost import (global_mesh, host_shard_to_global,
                                             initialize as initialize_multihost,
                                             sync_global_devices)
from tpulab_torch.parallel.pipeline import make_pipeline_train_step, pipeline_apply
from tpulab_torch.parallel.ring import (attention_reference, ring_attention, ulysses_attention,
                                        zigzag_ring_attention)

__all__ = [
    "make_mesh",
    "mesh_devices",
    "best_factorization",
    "parse_mesh_spec",
    "serving_mesh",
    "run_on_mesh",
    "mesh_anchor",
    "RankPool",
    "shared_pool",
    "launch",
    "distributed_reduce",
    "distributed_mean",
    "all_gather_op",
    "reduce_scatter_op",
    "roberts_sharded",
    "distributed_sort",
    "classify_sharded",
    "ring_attention",
    "zigzag_ring_attention",
    "ulysses_attention",
    "attention_reference",
    "make_pipeline_train_step",
    "pipeline_apply",
    "switch_moe",
    "switch_moe_reference",
    "global_mesh",
    "host_shard_to_global",
    "initialize_multihost",
    "sync_global_devices",
]
