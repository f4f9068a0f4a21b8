"""Device meshes over process groups, and the ranks that hold them (the
counterpart of ``tpulab.parallel.mesh``).

``tpulab`` is single-controller: one process drives every device of a
``jax.sharding.Mesh``.  The port is SPMD: one process (a *rank*) drives
one device, and ranks talk through ``torch.distributed``: gloo between
CPU ranks, NCCL between CUDA ranks, each on ``cuda:<rank>``.  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named axes over
every rank of the default process group (axis names as ``tpulab``'s:
``dp``, ``sp``, ``tp``, ``pp``, and ``x`` for the lab workloads).  Every
sharded function of :mod:`tpulab_torch.parallel` is called on every rank
with the same full host array and gives every rank the same full result:
``tpulab``'s single-controller API, read as SPMD.

:class:`RankPool` spawns the ranks (start method ``spawn``, a
``FileStore`` in a temporary directory), runs a function in each and
returns rank 0's result; :func:`launch` is one pool for one call.  In a
single process with no process group, :func:`make_mesh` makes one of a
single rank, so the sharded functions also run unlaunched, on one device;
a later call on the other device type raises, and does not run on that
group's.

``tpulab``'s serving helpers (``serving_mesh`` and after) wait for the
tp-sharded engine (ROADMAP A12.4).
"""

from __future__ import annotations

import datetime
import math
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: how long a rank waits in one collective before it fails
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)
#: how long the other ranks of a failed call may take to answer before
#: the pool is ended (a rank left waiting in a collective never answers)
FAILED_GRACE_S = 5.0
#: the process-group backend of each device type
BACKEND_OF = {"cpu": "gloo", "cuda": "nccl"}


def device_type_count(device_type: str) -> int:
    """Ranks a mesh of ``device_type`` can hold on this host: the CUDA
    cards, or on the CPU the cores this process may run on.  A CPU rank is
    a process with one thread, so the cores bound how many run at once;
    lab5's ``device_count`` (1 on the CPU, as ``tpulab``'s one host
    device) instead decides whether its ``--mesh`` engages at all."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    if device_type == "cpu":
        return len(os.sched_getaffinity(0))
    raise ValueError(f"unknown device type {device_type!r}; have {sorted(BACKEND_OF)}")


#: the device type of the group of one that :func:`ensure_group` made in
#: this process, if it made one (a launched rank's group is not one)
_IMPLICIT_GROUP: Optional[str] = None


def _device_type(backend: Optional[str]) -> str:
    """The device type a mesh is made for: ``backend``'s (the card unless
    ``"cpu"``), or in a launched rank where ``backend`` is None the
    process group's.  A ``backend`` that names another device type than
    the process group's raises: a collective never moves to the group's
    device in its place."""
    from tpulab_torch.runtime.device import BACKENDS, resolve_device

    if not dist.is_initialized():
        return resolve_device(backend).type
    have = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if backend is None and _IMPLICIT_GROUP is None:
        return have
    want = "cuda" if backend is None else str(backend).lower()
    if want not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if want != have:
        raise ValueError(f"backend {backend!r} asks for {want}, but this process's group is "
                         f"{dist.get_backend()} on {have}")
    return have


def mesh_devices(n: Optional[int] = None, *, backend: Optional[str] = None) -> List[torch.device]:
    """The devices of the first ``n`` ranks of ``backend``'s device type
    (all, if ``n`` is None): ``cuda:<rank>``, or the CPU for every rank."""
    kind = _device_type(backend)
    have = device_type_count(kind)
    n = have if n is None else n
    if have < n:
        raise ValueError(f"need {n} devices, have {have} ({kind})")
    return [torch.device(kind, i) if kind == "cuda" else torch.device("cpu") for i in range(n)]


def _prime_factors(n: int) -> list:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def best_factorization(n: int, axes: Sequence[str]) -> Dict[str, int]:
    """Factor ``n`` devices over ``axes`` as evenly as possible; later
    (innermost) axes take the larger factors.  Sizes multiply to ``n``."""
    sizes = {a: 1 for a in axes}
    order = list(axes)[::-1]  # innermost first
    for p in sorted(_prime_factors(n), reverse=True):
        tgt = min(order, key=lambda a: sizes[a])
        sizes[tgt] *= p
    assert math.prod(sizes.values()) == n
    return sizes


def ensure_group(device_type: str) -> None:
    """A process group to run collectives in: the default one where it
    exists, else one of a single rank (this process) on ``device_type``."""
    global _IMPLICIT_GROUP
    if dist.is_initialized():
        return
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group(BACKEND_OF[device_type], store=dist.HashStore(), rank=0,
                            world_size=1, timeout=COLLECTIVE_TIMEOUT)
    _IMPLICIT_GROUP = device_type


#: meshes by (device type, axis names, shape, group): a mesh's subgroups are
#: made collectively by every rank, once, not at every sharded call
_MESHES: Dict[tuple, Any] = {}


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, *, n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("x",), backend: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the process group, from explicit
    ``{axis: size}`` or by factoring ``n_devices`` (default: every rank)
    over ``axes``.  The sizes must multiply to the world size, and the
    world may not exceed the device type's count (:func:`device_type_count`);
    neither is shrunk to fit.  Meshes are kept per layout, so a layout's
    process groups are made once."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = _device_type(backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axis_sizes:
        names = tuple(axis_sizes)
        shape = tuple(int(axis_sizes[a]) for a in names)
    else:
        sizes = best_factorization(world if n_devices is None else int(n_devices), axes)
        names, shape = tuple(axes), tuple(sizes[a] for a in axes)
    n, have = math.prod(shape), device_type_count(kind)
    if max(n, world) > have:
        raise ValueError(f"need {max(n, world)} devices, have {have} ({kind})")
    ensure_group(kind)
    if n != world:
        raise ValueError(f"a mesh of {n} devices over {world} ranks: launch {n} ranks "
                         f"(RankPool) to hold it")
    key = (kind, names, shape, id(dist.group.WORLD))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(kind, shape, mesh_dim_names=names)
    return _MESHES[key]


def axis_mesh(mesh, axis: str, n_devices: Optional[int] = None,
              backend: Optional[str] = None):
    """``mesh``, or where it is None a 1-D mesh named ``axis`` over every
    rank (what ``tpulab``'s sharded functions build by default)."""
    if mesh is not None:
        return mesh
    return make_mesh(n_devices=n_devices, axes=(axis,), backend=backend)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of ``mesh`` (``tpulab``'s ``Mesh.shape``)."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_anchor(mesh) -> torch.device:
    """This rank's device in ``mesh``, where host data is staged."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def cpu_test_mesh(axis_sizes: Dict[str, int]):
    """A mesh over CPU ranks (gloo)."""
    return make_mesh(axis_sizes, backend="cpu")


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """``"AxB"`` -> ``(batch, model)`` axis sizes (the daemon's ``--mesh``
    grammar).  Both factors must be positive integers."""
    parts = str(spec).lower().split("x")
    if len(parts) != 2:
        raise ValueError(
            f"mesh spec {spec!r}: expected 'AxB' (batch x model), "
            f"e.g. '2x4'")
    try:
        batch, model = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"mesh spec {spec!r}: both factors must be integers") from None
    if batch < 1 or model < 1:
        raise ValueError(
            f"mesh spec {spec!r}: axis sizes must be >= 1")
    return batch, model


# ------------------------------------------------------------ ranks


def _to_host(out):
    """A result fit to leave its rank: tensors copied to the CPU."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_host(o) for o in out)
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    return out


def _rank_main(rank: int, world: int, device_type: str, store: str, conn) -> None:
    """One rank: join the group, then run each ``(fn, args, kwargs)`` that
    arrives, answering ``(ok, rank 0's result or None, or a traceback)``,
    until ``None`` arrives."""
    from tpulab_torch.runtime import fpenv

    torch.set_num_threads(1)
    fpenv.init_vml()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(BACKEND_OF[device_type], store=dist.FileStore(store, world),
                            rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            torch.set_num_threads(1)  # whatever importing fn's module set
            try:
                out = fn(*args, **kwargs)
                conn.send((True, _to_host(out) if rank == 0 else None))
            except Exception:  # reported; the rank serves on (an exit ends it)
                conn.send((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class RankPool:
    """``world_size`` ranks on ``device_type``, spawned once and kept for
    many calls: NCCL on the card with one GPU a rank (the default), or
    gloo where the caller asks for ``"cpu"``.

    ``run(fn, *args, **kwargs)`` calls ``fn`` (a module-level function, so
    it pickles by name) in every rank and returns rank 0's result, its
    tensors copied to the CPU.  A rank that raises or dies fails the call
    (``RuntimeError`` with its traceback or exit code); the pool stays
    only where every other rank answered (all refused alike), else it is
    ended.
    Ranks import what ``fn``'s module imports, and nothing of the caller's
    ``__main__`` but what the ``spawn`` start method re-imports."""

    def __init__(self, world_size: int, device_type: Optional[str] = None):
        from tpulab_torch.runtime.device import resolve_device

        device_type = resolve_device(device_type).type
        have = device_type_count(device_type)
        if not 0 < world_size <= have:
            raise ValueError(f"need {world_size} devices, have {have} ({device_type})")
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world_size, self.device_type = world_size, device_type
        self._dir = tempfile.mkdtemp(prefix="tpulab_torch_ranks_")
        store = os.path.join(self._dir, "store")
        self._conns, self._procs = [], []
        for rank in range(world_size):
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=_rank_main, daemon=True,
                               args=(rank, world_size, device_type, store, theirs))
            proc.start()
            theirs.close()
            self._conns.append(ours)
            self._procs.append(proc)

    def run(self, fn, *args, **kwargs):
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        answers: Dict[int, Any] = {}
        waiting = dict(enumerate(self._conns))
        failed, deadline = None, None
        while waiting:
            timeout = None if deadline is None else max(0.0, deadline - time.monotonic())
            ready = multiprocessing.connection.wait(
                list(waiting.values()) + [self._procs[r].sentinel for r in waiting], timeout)
            if not ready:
                break  # a rank failed and another waits for it in a collective
            for rank, conn in list(waiting.items()):
                if not (conn in ready or self._procs[rank].sentinel in ready):
                    continue
                try:
                    ok, payload = conn.recv()
                except EOFError:  # the rank ended without an answer
                    self._procs[rank].join(timeout=10)
                    code = self._procs[rank].exitcode
                    self.close(wait_s=0)
                    raise RuntimeError(f"rank {rank} of {self.world_size} died "
                                       f"(exit code {code})") from None
                if not ok and failed is None:
                    failed, deadline = (rank, payload), time.monotonic() + FAILED_GRACE_S
                answers[rank] = payload
                del waiting[rank]
        if failed is not None:
            if waiting:
                self.close(wait_s=0)
            raise RuntimeError(f"rank {failed[0]} of {self.world_size} failed:\n{failed[1]}")
        return answers[0]

    def close(self, wait_s: float = 10.0) -> None:
        """Stop every rank (asked first, ended after ``wait_s``; a failed
        call ends them at once, since the others may wait in a collective)
        and remove the store."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for proc in self._procs:
            proc.join(timeout=wait_s)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(fn, world_size: int, *args, device_type: Optional[str] = None, **kwargs):
    """``fn(*args, **kwargs)`` on ``world_size`` fresh ranks (on the card
    unless ``device_type`` is ``"cpu"``); rank 0's result."""
    with RankPool(world_size, device_type) as pool:
        return pool.run(fn, *args, **kwargs)
