"""The daemon's serving engine on a mesh of ranks.

``tpulab`` is single-controller: its daemon builds ``PagedEngine(mesh=...)``
as one object in its own process, and that object drives every device of a
GSPMD mesh.  The port is SPMD (:mod:`tpulab_torch.parallel.mesh`): an engine
on a mesh of N ranks is N ``PagedEngine`` objects, one in each rank of a
:class:`~tpulab_torch.parallel.mesh.RankPool`, and they stay in step only if
each sees the same calls in the same order.  ``tpulab`` has no counterpart of
this module: it is what lets the daemon's threads, queues and supervisor,
written against one engine object, drive N of them.

*The rank side.*  Each rank keeps its engines in a registry by key.
:func:`build` makes one from its recipe (the checkpoint path, read by every
rank itself, or the demo weights of seed 0; the serving knobs; the mesh's
axes), :func:`call` applies one method to it and :func:`drop` forgets it.
Rank 0 builds its engine with observability on, the others with it off (the
streams are the same either way), and answers every call with its result
and a small snapshot of what changed: finished outputs, each live request's
new tokens and changed fields, the queue and slot occupancy, the stats that
moved, and the latency observations, slow-log entries, journey marks and
trace events the engine recorded during the call.  A call that raises in
every rank alike (an injected fault, a full queue) carries the snapshot too,
taken at the raise.

*The daemon side.*  :class:`MeshEngine` has the surface of ``PagedEngine``
that the daemon uses.  Each method (``submit``, ``step``, ``cancel``,
``resubmit``, ``export_handoff``, ``import_handoff``, ``_lookup_prefix``,
which freshens the prefix cache's order) is one ``RankPool.run`` under the
pool's lock; before it, under the same lock, every rank is re-armed with the
daemon's fault schedule where that changed, and forgets the engines whose
fronts were collected.  The attributes the daemon reads (``pending``,
``active``, ``_done``, ``_inflight``, ``handoff_ready``, ``counters``,
``stats()`` and the rest) are mirrors refreshed from each snapshot: no
engine state changes between calls, so they answer without a round trip.
The requests in the mirrors are ``_Request`` objects of the daemon's own,
so a waiter's ticket keeps its request across a migration, and the
observability records are replayed into the daemon's stores (the ranks and
the daemon read the same host's ``CLOCK_MONOTONIC``).  The fields the daemon
writes on a request (``migrations`` and the handoff's) stay the daemon's.
The identity the fleet stamps on an engine (``replica_index``,
``pool_role``, ``fault_scope``, ``handoff_at_boundary``) goes to the ranks
with the next call.

Every engine of a pool shares its ranks, and the pool's lock puts the calls
of all of them, from every thread, in one order.  A rank that dies fails the
call and ends the pool; the mirrors keep the state of the last call that
answered, and :attr:`MeshEngine.lost` turns true.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import math
import pickle
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from tpulab_torch.models.paged import _Request

#: the request fields the daemon writes itself and a rank never overwrites
_DAEMON_FIELDS = ("migrations", "handoff_ms", "handoff_bytes")
#: the request fields a mirror takes from rank 0 (the stream and the prompt
#: are sent apart)
_FIELDS = tuple(f.name for f in dataclasses.fields(_Request)
                if f.name not in ("out", "prompt") + _DAEMON_FIELDS)
#: the engine's latency histograms, by their names in models/paged.py
_HISTOGRAMS = ("_H_QUEUE_WAIT", "_H_PREFILL", "_H_TTFT", "_H_ITL", "_H_E2E")


# ------------------------------------------------------------ the rank side


class _Records:
    """Rank 0's observability sink for one engine: stands in for the
    tracer, the journey store, the slow log and the latency histograms, and
    keeps what they are given, with its time, until the call's answer
    takes it."""

    enabled = True  # the tracer's flag

    def __init__(self):
        self.items: list = []

    def take(self) -> list:
        out, self.items = self.items, []
        return out

    # the tracer
    def event(self, name: str, arg=None, **args) -> None:
        self.items.append(("t", time.monotonic_ns(), "i", name, args or arg))

    def begin(self, name: str, arg=None) -> None:
        self.items.append(("t", time.monotonic_ns(), "B", name, arg))

    def end(self, name: str) -> None:
        self.items.append(("t", time.monotonic_ns(), "E", name, None))

    @contextlib.contextmanager
    def span(self, name: str):
        self.begin(name)
        try:
            yield self
        finally:
            self.end(name)

    # the journey store
    def mark(self, rid: int, name: str, *, t: Optional[float] = None, **kw) -> None:
        kw["t"] = time.monotonic() if t is None else t
        self.items.append(("j", rid, name, kw))

    # the slow log
    def record(self, entry) -> None:
        self.items.append(("s", dict(entry)))


class _Observed:
    """One histogram's stand-in."""

    def __init__(self, records: _Records, name: str):
        self.records, self.name = records, name

    def observe(self, value: float, rid=None) -> None:
        self.records.items.append(("h", self.name, float(value), rid))


def _frozen(value):
    return tuple(value) if isinstance(value, list) else value


class _Held:
    """A rank's engine, and on rank 0 what its mirrors have been sent."""

    def __init__(self, engine, observed: bool):
        self.engine = engine
        self.records = None
        if observed:
            self.records = _Records()
            engine._trace = engine._journey = self.records
        #: req_id -> (request, tokens sent, fields sent, n_resumed sent)
        self.sent: Dict[int, tuple] = {}
        self.stats: dict = {}

    @contextlib.contextmanager
    def capture(self):
        """The engine module's slow log and histograms record into this
        engine's sink for the call (a rank runs one call at a time)."""
        if self.records is None:
            yield
            return
        from tpulab_torch.models import paged

        saved = {n: getattr(paged, n) for n in _HISTOGRAMS + ("_SLOWLOG",)}
        for n in _HISTOGRAMS:
            setattr(paged, n, _Observed(self.records, saved[n].name))
        paged._SLOWLOG = self.records
        try:
            yield
        finally:
            for n, v in saved.items():
                setattr(paged, n, v)

    def _delta(self, req) -> dict:
        fields = tuple(_frozen(getattr(req, f)) for f in _FIELDS)
        prev = self.sent.get(req.req_id)
        if prev is None or prev[0] is not req:
            d = {f: getattr(req, f) for f in _FIELDS + _DAEMON_FIELDS}
            d.update(new=True, out=list(req.out), prompt=req.prompt, hops=list(req.hops))
        else:
            _, n_out, was, n_resumed = prev
            d = {f: getattr(req, f) for f, a, b in zip(_FIELDS, fields, was) if a != b}
            if "hops" in d:
                d["hops"] = list(req.hops)
            if len(req.out) > n_out:
                d["out"] = req.out[n_out:]
            if req.n_resumed != n_resumed:
                d["prompt"] = req.prompt
        self.sent[req.req_id] = (req, len(req.out), fields, req.n_resumed)
        return d

    def snapshot(self) -> dict:
        eng = self.engine
        live = [r for r in eng.pending] + [r for r in eng.active if r is not None]
        reqs = {}
        for req in live:
            d = self._delta(req)
            if d:
                reqs[req.req_id] = d
        ids = {r.req_id for r in live}
        for rid in [rid for rid in self.sent if rid not in ids]:
            req = self.sent[rid][0]
            d = self._delta(req)  # its last tokens: it finished or left
            if d:
                reqs[rid] = d
            del self.sent[rid]
        done = dict(eng._done)
        eng._done.clear()
        stats = eng.stats()
        moved = {k: v for k, v in stats.items() if self.stats.get(k) != v}
        self.stats = stats
        return {"reqs": reqs, "done": done,
                "pending": [r.req_id for r in eng.pending],
                "active": [None if r is None else r.req_id for r in eng.active],
                "handoff": [(s, r.req_id) for s, r in eng.handoff_ready],
                "inflight": len(eng._inflight), "stats": moved,
                "steady": bool(eng._steady),
                "obs": self.records.take() if self.records is not None else []}


#: this rank's engines, by the key their front gave them
_HELD: Dict[int, _Held] = {}


def _portable(err: Exception) -> Exception:
    """``err`` if it survives the pipe, else a ``RuntimeError`` naming it."""
    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:  # noqa: BLE001 — any unpicklable exception
        return RuntimeError(f"{type(err).__name__}: {err}")


def build(key: int, recipe: dict):
    """Build the engine of ``recipe`` in this rank as ``key``; rank 0
    answers with what its front mirrors for good (the config, the static
    byte figures) and the first snapshot."""
    from tpulab_torch.models.generate import serving_params
    from tpulab_torch.models.paged import PagedEngine
    from tpulab_torch.parallel.mesh import make_mesh

    params, cfg, _ = serving_params(recipe["path"])
    mesh = make_mesh(dict(recipe["axes"]), backend=recipe["device_type"])
    rank0 = dist.get_rank() == 0
    engine = PagedEngine(params, cfg, mesh=mesh, obs=rank0, **recipe["engine"])
    held = _HELD[key] = _Held(engine, observed=rank0)
    if not rank0:
        return None
    return {"cfg": engine.cfg, "slots": engine.slots, "spec_k": engine.spec_k,
            "spec_ngram": engine.spec_ngram, "counters": sorted(engine.counters),
            "shard_stats": engine.shard_stats(),
            "device_bytes": engine.device_bytes_estimate(),
            "mesh_devices": engine._mesh_devices, "max_pending": engine.max_pending,
            "snapshot": held.snapshot()}


def _run_method(eng, method: str, args, kwargs):
    if method == "step":
        return eng.step()
    if method == "submit":
        return eng.submit(*args, **kwargs)
    if method == "cancel":
        return eng.cancel(*args)
    if method == "resubmit":
        return eng.resubmit(*args, **kwargs)
    if method == "lookup_prefix":
        blocks, positions = eng._lookup_prefix(*args)
        return [int(b) for b in blocks], int(positions)
    if method == "export_handoff":
        return [(req.req_id, payload) for req, payload in eng.export_handoff()]
    if method == "import_handoff":
        return eng.import_handoff(*args)
    raise ValueError(f"no engine method {method!r}")


def call(key: int, method: str, args, kwargs, attrs: dict):
    """``method`` of this rank's engine ``key``, after setting ``attrs`` on
    it; rank 0 answers ``(result, snapshot)``.  A raise carries rank 0's
    snapshot (``rank_payload``)."""
    held = _HELD[key]
    eng = held.engine
    for name, value in attrs.items():
        setattr(eng, name, value)
    rank0 = dist.get_rank() == 0
    t0 = time.perf_counter()
    try:
        with held.capture():
            result = _run_method(eng, method, args, kwargs)
    except Exception as e:
        if rank0:
            e.rank_payload = ("raised", _portable(e), held.snapshot())
        else:
            eng._done.clear()
        raise
    if not rank0:
        eng._done.clear()  # only rank 0's outputs are read
        return None
    ms = (time.perf_counter() - t0) * 1e3
    return result, dict(held.snapshot(), ms=ms)


def drop(keys: List[int]) -> None:
    """Forget the engines ``keys`` (their fronts were collected)."""
    for key in keys:
        _HELD.pop(key, None)


def arm_faults(armed) -> None:
    """Arm this rank's fault injector with the daemon's ``(schedule,
    seed)``, or disable it for None."""
    from tpulab_torch import faults

    if armed is None:
        faults.disable()
    else:
        faults.configure(*armed)


# ------------------------------------------------------------ the daemon side

#: engine keys, unique in the daemon's process
_KEYS = itertools.count()
#: (pool, key) of collected fronts, dropped before the pool's next call (a
#: deque: a finalizer may run on any thread, inside any lock)
_DROPS: collections.deque = collections.deque()
#: per pool: the fault-schedule generation its ranks were armed with
_ARMED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: the pools fronts have used (``close_pools`` ends them)
_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def _collected(pool, key: int) -> None:
    _DROPS.append((pool, key))


def _before_call(pool) -> None:
    """Under ``pool.lock``: drop the collected engines and re-arm the fault
    schedule where the daemon's changed, before the next call."""
    from tpulab_torch import faults

    keys = []
    for _ in range(len(_DROPS)):
        try:
            held, key = _DROPS.popleft()
        except IndexError:
            break
        if held is pool:
            keys.append(key)
        elif held._procs:  # another live pool's: left for its own next call
            _DROPS.append((held, key))
    if keys:
        pool.run(drop, keys)
    inj = faults.INJECTOR
    if _ARMED.get(pool) != inj.generation:
        gen, armed = inj.generation, inj.armed
        pool.run(arm_faults, armed)
        _ARMED[pool] = gen


def close_pools() -> None:
    """End every rank pool a :class:`MeshEngine` used (the daemon's
    shutdown: no rank outlives it)."""
    for pool in list(_POOLS):
        pool.close()


class MeshEngine:
    """A ``PagedEngine`` built in every rank of a pool, as the daemon sees
    it (see the module's docstring).

    ``axes`` is the serving mesh (``{"batch": b, "model": m}``, or the
    legacy ``{"tp": n}``), over ``b * m`` ranks of
    :func:`~tpulab_torch.parallel.mesh.shared_pool` on ``device_type`` (the
    card unless ``"cpu"``); ``path`` a checkpoint in the port's format (its
    sidecar's config, LoRA folded) or None for the demo weights of seed 0;
    ``engine_kw`` the ``PagedEngine`` knobs.  There is no fallback: a rank
    that fails to start or to build raises here."""

    #: what the fleet stamps on an engine and the ranks must see
    _FORWARDED = ("replica_index", "pool_role", "fault_scope", "handoff_at_boundary")

    def __init__(self, axes: Dict[str, int], path: Optional[str] = None, *,
                 device_type: Optional[str] = None, **engine_kw):
        from tpulab_torch.obs import compilestats
        from tpulab_torch.obs.roofline import per_token_flops
        from tpulab_torch.parallel.mesh import shared_pool
        from tpulab_torch.runtime.device import resolve_device

        self.__dict__["_attrs"] = {}
        kind = resolve_device(device_type).type
        self.axes = dict(axes)
        pool = self._pool = shared_pool(math.prod(int(v) for v in axes.values()), kind)
        _POOLS.add(pool)
        self._key = next(_KEYS)
        self.draft = None
        self.replica_index = self.pool_role = self.fault_scope = None
        self.handoff_at_boundary = False
        self._reqs: Dict[int, _Request] = {}
        self._gone: Dict[int, _Request] = {}
        self._done: Dict[int, np.ndarray] = {}
        self.pending: List[_Request] = []
        self.active: List[Optional[_Request]] = []
        self.handoff_ready: list = []
        self._inflight: list = []
        self._stats: dict = {}
        self._steady = False
        #: calls forwarded, and rank 0's milliseconds inside their methods
        #: (the rest of a call's time is the pipes, pickling and snapshots)
        self.calls, self.rank_ms = 0, 0.0
        recipe = {"path": path, "axes": self.axes, "device_type": kind, "engine": engine_kw}
        with pool.lock:
            _before_call(pool)
            info = pool.run(build, self._key, recipe)
        weakref.finalize(self, _collected, pool, self._key)
        self.cfg, self.slots, self.spec_k = info["cfg"], info["slots"], info["spec_k"]
        self.spec_ngram, self.max_pending = info["spec_ngram"], info["max_pending"]
        self._shard_stats, self._dev_bytes = info["shard_stats"], info["device_bytes"]
        self._mesh_devices = info["mesh_devices"]
        self.counters = {k: 0 for k in info["counters"]}
        self.active = [None] * self.slots
        self._apply(info["snapshot"])
        # the MFU gauge's per-tick flops, which the engine registers in its
        # own process
        compilestats.COMPILESTATS.set_model_flops(
            "paged_tick", float(self.slots * per_token_flops(self.cfg)))

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in self._FORWARDED:
            self._attrs[name] = value

    @property
    def lost(self) -> bool:
        """The ranks are gone (one died, or the pool was closed)."""
        return not self._pool.alive

    @property
    def rank_pids(self) -> List[int]:
        """The process ids of the ranks that hold this engine."""
        return self._pool.pids

    # ------------------------------------------------------------ calls
    def _call(self, method: str, *args, mirror: Optional[_Request] = None, **kwargs):
        """One method in every rank; its result.  ``mirror`` is the
        daemon's request that the call's result id names from then on."""
        from tpulab_torch.parallel.mesh import RankError

        pool = self._pool
        with pool.lock:
            _before_call(pool)
            attrs, self.__dict__["_attrs"] = self._attrs, {}
            try:
                result, snap = pool.run(call, self._key, method, args, kwargs, attrs)
            except RankError as e:
                if isinstance(e.payload, tuple) and e.payload[:1] == ("raised",):
                    _, err, snap = e.payload
                    self._apply(snap)
                    raise err from e
                raise
            if mirror is not None:
                self._reqs[result] = mirror
            self._apply(snap)
        return result

    def _apply(self, snap: dict) -> None:
        """Refresh the mirrors from rank 0's snapshot, and replay its
        observability records into this process's stores."""
        reqs = self._reqs
        for rid, d in snap["reqs"].items():
            m = reqs.get(rid)
            if m is None:
                m = reqs[rid] = _Request(rid, d["prompt"], d["max_new"])
                for f in _DAEMON_FIELDS:
                    setattr(m, f, d[f])
            for f in _FIELDS:
                if f in d:
                    setattr(m, f, d[f])
            if d.get("new"):
                m.out[:] = d["out"]
            elif "out" in d:
                m.out.extend(d["out"])
            if "prompt" in d:
                m.prompt = d["prompt"]
        self._done.update(snap["done"])
        self._replay(snap["obs"])
        self.pending = [reqs[i] for i in snap["pending"]]
        self.active = [None if i is None else reqs[i] for i in snap["active"]]
        self.handoff_ready = [(s, reqs[i]) for s, i in snap["handoff"]]
        live = set(snap["pending"]) | {i for i in snap["active"] if i is not None}
        self._gone = {i: m for i, m in reqs.items() if i not in live}
        for i in self._gone:
            del reqs[i]
        self._inflight = [None] * snap["inflight"]
        self._stats.update(snap["stats"])
        self.counters.update({k: v for k, v in snap["stats"].items() if k in self.counters})
        self._steady = snap["steady"]
        if "ms" in snap:
            self.calls += 1
            self.rank_ms += snap["ms"]

    def _replay(self, items: list) -> None:
        from tpulab_torch.models import paged
        from tpulab_torch.obs import journey, slowlog, tracer

        if not items:
            return
        hists = {h.name: h for h in (getattr(paged, n) for n in _HISTOGRAMS)}
        by_rid = {m.rid: m for m in self._reqs.values()}
        for item in items:
            kind = item[0]
            if kind == "h":
                hists[item[1]].observe(item[2], rid=item[3])
            elif kind == "t":
                tracer.TRACER.record_at(*item[1:])
            elif kind == "j":
                journey.JOURNEY.mark(item[1], item[2], **item[3])
            else:
                entry = item[1]
                m = by_rid.get(entry.get("rid"))
                if m is not None:  # what the daemon wrote on the request
                    entry.update({f: getattr(m, f) for f in _DAEMON_FIELDS})
                slowlog.SLOWLOG.record(entry)

    # ------------------------------------------------------------ the engine's surface
    def submit(self, prompt, max_new: int, **kw) -> int:
        return self._call("submit", np.asarray(prompt, np.int32).reshape(-1), max_new, **kw)

    def step(self) -> List[int]:
        return self._call("step")

    def cancel(self, req_id: int) -> str:
        return self._call("cancel", req_id)

    def resubmit(self, req: _Request, fresh_id: bool = False) -> int:
        """Requeue ``req`` (the daemon's request object, which stays its
        handle) in every rank: each takes a copy, and ``req`` mirrors rank
        0's copy from then on."""
        if req.cancelled:
            raise ValueError("resubmit of a cancelled request")
        return self._call("resubmit", req, fresh_id, mirror=req)

    def export_handoff(self) -> list:
        out = self._call("export_handoff")
        return [(self._gone.get(i) or self._reqs[i], payload) for i, payload in out]

    def import_handoff(self, payload: list) -> int:
        return self._call("import_handoff", payload)

    def _lookup_prefix(self, prompt):
        """Forwarded like any call: on the dict index a hit freshens the
        cache's eviction order, which every rank must share."""
        return self._call("lookup_prefix", np.asarray(prompt, np.int32).reshape(-1))

    def set_draft(self, draft_params, draft_cfg=None):
        from tpulab_torch.models.paged import EngineConfigError

        raise EngineConfigError(
            "the dense-draft proposer is uncertified on mesh "
            "serving (use spec='lookup')")

    # ------------------------------------------------------------ mirrors
    @property
    def inflight_depth(self) -> int:
        return len(self._inflight)

    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def shard_stats(self) -> Dict[int, Dict[str, int]]:
        return self._shard_stats

    def device_bytes_estimate(self) -> int:
        return self._dev_bytes
