"""``tpulab_torch.parallel.multihost``: the cases of ``tests/test_multihost.py``
for the port, whose ranks each drive one device.

Single-process semantics in this process; the node-major global mesh on
four gloo ranks launched as two nodes of two (``LOCAL_WORLD_SIZE=2``),
spawned once for the module; and two real processes that join through
``initialize`` from ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``
alone (a TCP store on localhost), build the global mesh, assemble a global
batch from each process's rows and reduce it.  The ranks import this
module for its rank-side helpers, so it imports neither JAX nor
``tpulab`` at its top.
"""

import os
import pathlib
import socket
import subprocess
import sys
import typing

import numpy as np
import pytest
import torch

from tpulab_torch.parallel import RankPool
from tpulab_torch.parallel.mesh import mesh_shape
from tpulab_torch.parallel.multihost import (global_mesh, host_shard_to_global, initialize,
                                             runtime_info, sync_global_devices)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def two_nodes():
    """Four ranks as two nodes of two."""
    old = os.environ.get("LOCAL_WORLD_SIZE")
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        pool = RankPool(4, "cpu")
    finally:
        if old is None:
            del os.environ["LOCAL_WORLD_SIZE"]
        else:
            os.environ["LOCAL_WORLD_SIZE"] = old
    yield pool
    pool.close()


def _layout():
    mesh = global_mesh(("dp", "sp", "tp"))
    return {"info": runtime_info(), "shape": mesh_shape(mesh), "ranks": mesh.mesh.tolist(),
            "names": list(mesh.mesh_dim_names),
            "explicit": mesh_shape(global_mesh(("dp", "tp"), {"dp": 2, "tp": 2})),
            "flat": mesh_shape(global_mesh(("dp",), {"dp": 4}))}


def _assembled():
    node = runtime_info()["process_index"]
    local = np.arange(8, dtype=np.float32).reshape(2, 4) + 10 * node  # this node's rows
    out = host_shard_to_global(local, global_mesh(("dp", "tp")), ("dp", None))
    sync_global_devices("test")
    return out


class TestInitialize:
    def test_noop_outside_a_launch(self, monkeypatch):
        from tpulab.parallel.multihost import initialize as jax_initialize

        for k in ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
                  "MEGASCALE_COORDINATOR_ADDRESS"):
            monkeypatch.delenv(k, raising=False)
        assert initialize() is False
        assert jax_initialize() is False

    def test_noop_beside_an_unlaunched_group_of_one(self):
        """A group of one that an unlaunched mesh made for this process is
        no launch: ``initialize`` still answers False (a fresh process, so
        no other test's group is in the way)."""
        code = ("import os\n"
                "for k in ('MASTER_ADDR', 'RANK', 'WORLD_SIZE'): os.environ.pop(k, None)\n"
                "from tpulab_torch.parallel.mesh import make_mesh\n"
                "from tpulab_torch.parallel.multihost import initialize\n"
                "make_mesh(backend='cpu')\n"
                "print(initialize())\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["False"]

    def test_runtime_info_of_one_process(self, monkeypatch):
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        assert runtime_info() == {"process_index": 0, "process_count": 1,
                                  "local_device_count": 1, "global_device_count": 1}

    def test_annotations_resolvable(self):
        import tpulab_torch.parallel.multihost as mh

        typing.get_type_hints(mh.host_shard_to_global)
        typing.get_type_hints(mh.initialize)

    def test_sync_is_noop_single_process(self):
        sync_global_devices("test")  # must not raise


class TestGlobalMesh:
    def test_nodes_lead_and_every_rank_is_covered(self, two_nodes):
        got = two_nodes.run(_layout)
        assert got["info"] == {"process_index": 0, "process_count": 2,
                               "local_device_count": 2, "global_device_count": 4}
        assert got["names"] == ["dp", "sp", "tp"]
        assert got["shape"] == {"dp": 2, "sp": 1, "tp": 2}
        # node 0's ranks fill the first dp slice: inner axes never cross nodes
        assert got["ranks"] == [[[0, 1]], [[2, 3]]]
        assert got["explicit"] == {"dp": 2, "tp": 2} and got["flat"] == {"dp": 4}

    def test_host_locality_matches_tpulabs_rule(self, two_nodes):
        """tpulab's rule on a mocked 2-process x 4-local topology: the
        leading axis takes the process count, the inner axes factor the
        local count; the port's on 2 nodes x 2 ranks, the same rule."""
        from tpulab.parallel.mesh import best_factorization as jax_factor

        got = two_nodes.run(_layout)
        assert got["shape"] == {"dp": 2, **jax_factor(2, ("sp", "tp"))}

    def test_assembles_the_global_batch(self, two_nodes):
        got = two_nodes.run(_assembled)
        want = np.concatenate([np.arange(8, dtype=np.float32).reshape(2, 4) + 10 * n
                               for n in (0, 1)])
        assert got.shape == (4, 4) and got.numpy().tobytes() == want.tobytes()


WORKER = """
import sys
import numpy as np
from tpulab_torch.parallel.multihost import (
    global_mesh, host_shard_to_global, initialize, runtime_info, sync_global_devices)
from tpulab_torch.parallel.collectives import distributed_reduce
pid = int(sys.argv[1])
assert initialize(), "initialize returned False"
assert runtime_info()["process_count"] == 2, runtime_info()
mesh = global_mesh(("dp", "tp"))
from tpulab_torch.parallel.mesh import mesh_shape
assert mesh_shape(mesh) == {"dp": 2, "tp": 1}, mesh_shape(mesh)
local = np.full((2, 4), pid, np.float32)   # my half of the global batch
garr = host_shard_to_global(local, mesh, ("dp", None))
assert tuple(garr.shape) == (4, 4)
assert float(garr.sum()) == 8.0, float(garr.sum())   # proc0 zeros + proc1 ones
total = float(distributed_reduce(garr.reshape(-1).numpy(), "sum", mesh=mesh, axis="dp"))
assert total == 8.0, total
sync_global_devices("smoke")
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "tpulab."))]
print(f"proc {pid} OK")
"""


class TestTwoProcessSmoke:
    def test_initialize_from_the_environment_and_reduce(self):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = []
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE="2",
                       MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            env.pop("LOCAL_WORLD_SIZE", None)
            procs.append(subprocess.Popen([sys.executable, "-c", WORKER, str(rank)], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True, cwd=ROOT))
        outs = [p.communicate(timeout=180)[0] for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"proc {i} failed:\n{out}"
            assert f"proc {i} OK" in out
