"""Warm-runtime daemon of the port: one PyTorch process behind a unix socket.

The counterpart of ``tpulab.daemon``.  The native thin client
(``native/client/tpulab_client.cpp``) speaks the reference suite's
stdin/stdout contract and forwards over the socket, so a harness still
sees a subprocess-per-run binary while the model, its ``PagedEngine``
replicas and the built kernels stay warm on the card.

Wire protocol (all integers little-endian), ``tpulab``'s byte for byte:

    request:  u32 header_len | header JSON | u64 payload_len | payload
              header = {"lab": str, "sweep": bool, "backend": str|null,
                        "config": {...}}       payload = stdin text bytes
    response: zero or more CHUNK frames (u8 status=2 | u64 len | bytes;
              only for generate with config {"stream": true} — each
              carries the next incremental output bytes), then exactly
              one terminal frame: u8 status (0 ok / 1 error) | u64 len |
              output bytes (the FULL output, chunks included)

Requests: the lab names of :mod:`tpulab_torch.labs` (run under one lock,
on the header's ``backend`` or the daemon's), ``platform`` (the torch
device type the daemon computes on: ``cuda`` on the card), ``generate``
(byte-LM or BPE continuation through the fleet below), and the
observability requests: ``generate_stats``, ``metrics`` (Prometheus
text: the ttft/itl/e2e/queue-wait/prefill histograms and the
``engine_*`` gauges summed across warm engines, with a per-replica
breakdown), ``trace_dump`` (Chrome trace-event JSON of the tracer
ring), ``compile_stats`` (the build ledger, peaks and MFU gauges),
``postmortem`` (the newest flight-recorder bundle), ``slowlog`` (the
worst requests by e2e latency), ``journey`` (a request's stitched
phase waterfall), ``history`` (windowed rates and percentiles from the
sampler's ring) and ``alerts`` (the rule engine's state table), the
fleet's ``fleet``, ``drain`` and ``undrain``, and ``resume`` (continue
a journaled stream by rid).

Every ``generate`` goes through a fleet of ``--replicas N``
``PagedEngine`` replicas behind the router (:mod:`tpulab_torch.router`):
least-loaded plus prefix-affinity placement over health-checked
replicas; a crashed replica is quarantined, its in-flight requests
migrate to healthy peers (``PagedEngine.resubmit``: greedy streams
stay bit-identical; ``TPULAB_DAEMON_REPLAY_BUDGET`` moves per request)
and it rebuilds in the background; ``drain``/``undrain`` compose a
zero-shed rolling restart; ``--hedge-ms`` duplicates a request with no
first token inside the budget; a ``replica.preempt`` fault is a spot
preemption notice.  ``deadline_ms`` sheds with the parseable
``shed retry_after_ms=N`` line once the recent queue-wait p99 blows
the budget.

The control plane, ``tpulab``'s: every ``--metrics-interval`` seconds
(default 1) the sampler appends a registry snapshot to the history
ring, evaluates the alert catalog and maps each replica's
``replica_degraded`` alert onto its health (SUSPECT while firing);
``--journal PATH`` fsyncs each request's accept record before admission
and replays incomplete requests on restart, resumable by rid;
``--autoscale-min/--autoscale-max`` arm the autoscaler and the brownout
ladder on the sampler tick; ``--pool-spec prefill=N,decode=M`` splits
the fleet into prefill and decode pools joined by the KV handoff.

A ``beams`` request runs beam search on a replica's model outside the
batching engine, one at a time (``_SPEC_LOCK``), and answers unstreamed.

The serving mesh, ``tpulab``'s: ``--mesh AxB`` (or ``TPULAB_DAEMON_MESH``)
serves every engine over a 2-D ``batch x model`` mesh (KV pools and
attention heads split on the model axis, the per-slot decode state on the
batch axis), a request's ``{"mesh": "AxB"}`` overrides it, and the legacy
``{"tp": N}`` serves over a 1-D tp mesh of N devices; ``"1x1"`` and ``""``
serve on one device.  The port is SPMD, so a mesh replica's engine is a
``PagedEngine`` built in every rank of a rank pool (NCCL on the card, gloo
with ``--backend cpu``) and driven from here through
:class:`tpulab_torch.parallel.mesh_engine.MeshEngine`; a rank that fails
fails its replica, which quarantines and rebuilds like any other.

Run: ``python -m tpulab_torch.daemon --socket /tmp/tpulab.sock``
(``--backend cpu`` to serve on the host; the card otherwise, with no
fallback).  Stop: SIGTERM/SIGINT.
"""

from __future__ import annotations

import argparse
import itertools as _itertools
import json
import os
import re
import signal
import socket
import struct
import sys
import threading
import time
import traceback
import weakref
from typing import Optional

from tpulab_torch import faults as _faults
from tpulab_torch import obs as _obs
from tpulab_torch import router as _router
from tpulab_torch.parallel.mesh import RankDied



# Wire-size ceilings: the length prefixes are attacker-controlled (any
# local process can connect), so cap them before allocating.  The
# payload ceiling fits the largest documented workload input (lab2 at
# its 1e8-px bound serializes to ~0.9 GB of hex text) with headroom;
# override via TPULAB_DAEMON_MAX_PAYLOAD for bigger custom runs.
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = int(
    os.environ.get("TPULAB_DAEMON_MAX_PAYLOAD", 2 << 30)
)
#: concurrent connection-handler threads (each may hold a payload
#: buffer); excess connections queue in accept order
MAX_CONN_THREADS = 32
#: bound on every per-connection socket operation (recv AND sendall) so a
#: stalled/half-dead client releases its handler slot instead of holding
#: it forever; generous because legit clients stream multi-MB payloads
#: over the loopback in well under a second (env-tunable so tests can
#: exercise the stall path without waiting a minute)
RECV_TIMEOUT_S = float(os.environ.get("TPULAB_DAEMON_RECV_TIMEOUT_S", "60"))
#: AGGREGATE staged-payload ceiling across all connections — the
#: per-connection cap alone would still let MAX_CONN_THREADS clients
#: stage MAX_CONN_THREADS x MAX_PAYLOAD_BYTES concurrently
MAX_TOTAL_PAYLOAD_BYTES = int(
    os.environ.get("TPULAB_DAEMON_MAX_TOTAL_PAYLOAD", 4 << 30)
)


def _recv_exact(conn: socket.socket, n: int,
                deadline: float | None = None) -> bytearray:
    # returned as the bytearray itself: a bytes() copy would double the
    # peak payload footprint outside the _ByteBudget accounting (every
    # consumer — json.loads, .decode, np.frombuffer — takes bytearray)
    #
    # deadline is an ABSOLUTE time.monotonic() bound on the whole frame:
    # a per-op settimeout alone resets on every recv, so a client
    # trickling one byte per interval would hold its handler slot
    # forever — the remaining-time settimeout below closes that.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"frame receive deadline exceeded "
                                   f"({got}/{n} bytes)")
            conn.settimeout(remaining)
        r = conn.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-message")
        got += r
    return buf


class _ByteBudget:
    """Aggregate allocation budget: payload reads block until they fit.

    A single request within the per-connection cap always proceeds when
    it is alone (``used > 0`` guard), so the budget throttles floods
    without deadlocking a legitimate large payload."""

    def __init__(self, total: int):
        self.total = total
        self.used = 0
        self.cond = threading.Condition()

    def acquire(self, n: int) -> None:
        with self.cond:
            while self.used > 0 and self.used + n > self.total:
                self.cond.wait()
            self.used += n

    def release(self, n: int) -> None:
        with self.cond:
            self.used -= n
            self.cond.notify_all()


#: one serving-length policy: the paged engines' max_seq AND the cap on


#: one serving-length policy: the paged engines' max_seq
_SERVE_MAX_SEQ = 512

#: verify window the shared engines are built with (requests' draft_k
#: <= this): speculative requests batch through the same PagedEngine
#: ticks as plain traffic
_SPEC_K = 4

#: default prefill window of the daemon's engines: chunked prefill,
#: interleaved with the running batch's decode ticks.  Per-request
#: override via config {"prefill_chunk": N}; 0 prefills the whole
#: prompt at admission.  ``--prefill-chunk`` sets the daemon default.
PREFILL_CHUNK = 32

#: prefix-index structure of the daemon's engines ("dict" or "radix");
#: ``--prefix-index`` overrides at startup, daemon-wide
PREFIX_INDEX = os.environ.get("TPULAB_DAEMON_PREFIX_INDEX", "dict")

#: host-RAM spill tier capacity in KV blocks (0 = disarmed); needs
#: ``--prefix-index radix``
SPILL_BLOCKS = int(os.environ.get("TPULAB_DAEMON_SPILL_BLOCKS", "0"))

#: host-tier payload format: "native" (lossless), "int8" or "int4"
SPILL_DTYPE = os.environ.get("TPULAB_DAEMON_SPILL_DTYPE", "native")

#: serving mesh spec "AxB" (batch x model axis sizes; "" = no mesh:
#: one-device engines).  KV pools and attention heads split on the model
#: axis, the per-slot decode state on the batch axis.  Daemon-wide default
#: via ``--mesh`` / this env; per-request override via config {"mesh":
#: "AxB"}.  Mutually exclusive with the legacy per-request {"tp": N} knob.
MESH_SPEC = os.environ.get("TPULAB_DAEMON_MESH", "")

#: bounded admission: each engine's pending queue caps here, and a
#: submit past the bound sheds with retry-after
MAX_PENDING = int(os.environ.get("TPULAB_DAEMON_MAX_PENDING", "64"))

#: replay budget: how many replica failures one request may ride
#: through (each migration charges one) before its failure surfaces
REPLAY_BUDGET = int(os.environ.get("TPULAB_DAEMON_REPLAY_BUDGET", "2"))

#: fleet size per warm serving config (``--replicas N`` overrides)
REPLICAS = int(os.environ.get("TPULAB_DAEMON_REPLICAS", "1"))

#: hedge budget in milliseconds (0 = off); ``--hedge-ms`` and the
#: per-request ``hedge_ms`` override
HEDGE_MS = float(os.environ.get("TPULAB_DAEMON_HEDGE_MS", "0"))

#: how long a submit may park waiting for some replica to become
#: placeable before the ``rebuilding retry_after_ms=N`` error frame
REBUILD_PARK_S = float(os.environ.get("TPULAB_DAEMON_REBUILD_PARK_S", "30"))

#: the shed check reads the queue-wait p99 over roughly this window
QUEUE_WAIT_WINDOW_S = float(
    os.environ.get("TPULAB_DAEMON_QUEUE_WAIT_WINDOW_S", "60"))

#: history sampler cadence: every interval the daemon refreshes the
#: engine gauge mirror, appends one registry snapshot to the history
#: ring (tpulab_torch.obs.history — the ``history`` request), and
#: evaluates the alert rule catalog (tpulab_torch.obs.alerts — the
#: ``alerts`` request).  ``--metrics-interval`` overrides; 0 disables the
#: sampler (history/alerts requests still answer, from whatever was
#: sampled).
METRICS_INTERVAL_S = float(
    os.environ.get("TPULAB_DAEMON_METRICS_INTERVAL_S", "1.0"))

#: history ring capacity in samples (15 min at the 1 s default cadence)
HISTORY_CAPACITY = int(os.environ.get("TPULAB_DAEMON_HISTORY", "900"))

#: elastic fleet: autoscale bounds.  ``--autoscale-max N`` (N >= 1) arms
#: the telemetry-driven controller (tpulab_torch/autoscale.py) riding the
#: history sampler tick: the fleet grows toward AUTOSCALE_MAX under
#: sustained pressure and shrinks back to the AUTOSCALE_MIN floor as it
#: decays, one replica per decision, with per-direction cooldowns and
#: flap hysteresis.  0 (the default) disables the controller entirely —
#: the fleet stays the fixed ``--replicas N``.
AUTOSCALE_MIN = int(os.environ.get("TPULAB_DAEMON_AUTOSCALE_MIN", "1"))
AUTOSCALE_MAX = int(os.environ.get("TPULAB_DAEMON_AUTOSCALE_MAX", "0"))

#: brownout rung 3 (``token_cap``): new admissions' max output tokens
#: are capped here while the ladder holds level >= 3
BROWNOUT_TOKEN_CAP = int(
    os.environ.get("TPULAB_DAEMON_BROWNOUT_TOKEN_CAP", "64"))

#: signal window the autoscale controller reads (queue-wait p99, shed
#: rate) — shorter than the shed check's QUEUE_WAIT_WINDOW_S so the
#: controller reacts to the ramp edge, not the hour
AUTOSCALE_WINDOW_S = float(
    os.environ.get("TPULAB_DAEMON_AUTOSCALE_WINDOW_S", "15"))

#: disaggregated serving: ``--pool-spec`` / this env assigns pool ROLES
#: to the fleet's replicas instead of the uniform unified fleet.
#: Syntax: comma-separated ``role=N`` (fixed) or ``role=MIN..MAX``
#: (independently autoscaled pool) with role in {prefill, decode,
#: unified}, e.g. ``prefill=1..2,decode=1``.  A prefill replica admits
#: new requests and exports their KV at the PREFILLING->DECODING edge; a
#: decode replica imports those blocks through its spill tier's
#: admission prefetch and serves the decode.  Requires ``--prefix-index
#: radix --spill-blocks > 0`` (the handoff rides the digest-keyed
#: host-block wire format); "" (default) keeps the unified fleet.
POOL_SPEC = os.environ.get("TPULAB_DAEMON_POOL_SPEC", "")

#: decode-pool ITL burn mark (seconds): the decode pool's autoscale
#: policy treats a window ITL p99 at/above this as overload evidence
#: (queue-wait burn stays the prefill/unified pools' signal)
POOL_ITL_HIGH_S = float(
    os.environ.get("TPULAB_DAEMON_POOL_ITL_HIGH_S", "0.5"))

#: the device the daemon serves on: "cuda" unless ``--backend cpu``
BACKEND = "cuda"

#: fault-tolerance and fleet counters (in every ``metrics`` scrape)
_C_RESTARTS = _obs.counter(
    "daemon_engine_restarts",
    "engine step loops quarantined and rebuilt by the supervisor")
_C_REPLAYS = _obs.counter(
    "daemon_replays", "in-flight requests replayed into a rebuilt engine")
_C_SHED = _obs.counter(
    "daemon_shed_requests",
    "requests rejected with retry-after (deadline/backpressure shedding)")
_C_MIGRATIONS = _obs.counter(
    "daemon_migrations",
    "in-flight requests migrated to a healthy peer replica after a "
    "replica failure")
_C_HEDGES = _obs.counter(
    "daemon_hedges",
    "straggler requests duplicated onto a second replica (hedged "
    "retries; first token wins)")
_C_HEDGE_WINS = _obs.counter(
    "daemon_hedge_wins",
    "hedged requests whose duplicate produced the first token (the "
    "original was cancelled)")
_C_DRAINS = _obs.counter(
    "daemon_drains",
    "replica drain operations accepted (placement stopped; replica "
    "rebuilds once quiesced)")
#: crash flight recorder: post-mortem bundles persisted at replica
#: quarantine (obs/flightrec.py)
_C_POSTMORTEMS = _obs.counter(
    "daemon_postmortems",
    "crash post-mortem bundles persisted by the flight recorder "
    "(engine quarantines + replica failures)")
#: crash-durability counters: the write-ahead request journal
#: (tpulab_torch/durability.py) and the restart-recovery machinery
#: built on it
_C_JOURNAL_RECORDS = _obs.counter(
    "daemon_journal_records",
    "write-ahead journal records appended (accepts fsynced before "
    "admission + committed-prefix checkpoints + completion records)")
_C_RECOVERIES = _obs.counter(
    "daemon_recoveries",
    "incomplete journaled requests replayed to completion after a "
    "daemon process restart")
_C_RESUMED_STREAMS = _obs.counter(
    "daemon_resumed_streams",
    "client streams continued by rid after a reconnect (resume "
    "requests answered from the journal-backed stream table)")
#: elastic-fleet counters/gauges: the autoscale controller's
#: reconciliations, the brownout ladder's rung transitions, and the
#: spot-preemption drill — every fleet-shape change is counted, and the
#: two gauges make the CURRENT control state scrapeable (target vs
#: actual replicas, ladder level)
_C_SCALE_OUTS = _obs.counter(
    "daemon_scale_outs",
    "replicas added by the autoscaler (fresh spawns + retired-slot "
    "revivals, each warmed and placed into service)")
_C_SCALE_INS = _obs.counter(
    "daemon_scale_ins",
    "replicas retired by the autoscaler (drained, in-flight requests "
    "migrated to peers, engine released)")
_C_SPOT_PREEMPTIONS = _obs.counter(
    "daemon_spot_preemptions",
    "spot-preemption notices delivered to replicas (replica.preempt "
    "drills: deadline-bounded drain-and-migrate, then release)")
_C_BROWNOUT_STEPS = _obs.counter(
    "daemon_brownout_steps",
    "brownout ladder rungs engaged under sustained pressure "
    "(hedging_off -> spec_off -> token_cap -> deadline_tight)")
_C_BROWNOUT_REVERSALS = _obs.counter(
    "daemon_brownout_reversals",
    "brownout ladder rungs released (reverse order) as pressure "
    "decayed")
_G_TARGET_REPLICAS = _obs.gauge(
    "fleet_target_replicas",
    "the autoscale controller's current target replica count, summed "
    "across armed fleets (0 = autoscaling disabled)")
_G_BROWNOUT_LEVEL = _obs.gauge(
    "daemon_brownout_level",
    "current brownout ladder level (0 = healthy, 4 = every rung "
    "engaged), worst across armed fleets")
#: disaggregated-serving counters/gauges: every cross-engine KV handoff
#: is counted with its wire bytes, and the per-pool gauges make each
#: pool's serving vs target replica count scrapeable
_C_HANDOFFS = _obs.counter(
    "daemon_handoffs",
    "requests handed off prefill-engine -> decode-engine at the "
    "PREFILLING->DECODING edge (KV blocks exported, imported through "
    "the peer's spill tier, stream resumed there)")
_C_HANDOFF_BYTES = _obs.counter(
    "handoff_bytes",
    "encoded KV payload bytes accepted by decode-side spill tiers "
    "across all handoffs (the wire size in the configured spill "
    "dtype, quantization included)")
_G_POOL_PREFILL_REPLICAS = _obs.gauge(
    "pool_prefill_replicas",
    "serving (non-retired) replicas currently in the prefill pool "
    "(0 = no disaggregated fleet armed)")
_G_POOL_PREFILL_TARGET = _obs.gauge(
    "pool_prefill_target",
    "the prefill pool's autoscale target replica count (its floor "
    "when the pool is fixed-size)")
_G_POOL_DECODE_REPLICAS = _obs.gauge(
    "pool_decode_replicas",
    "serving (non-retired) replicas currently in the decode pool "
    "(0 = no disaggregated fleet armed)")
_G_POOL_DECODE_TARGET = _obs.gauge(
    "pool_decode_target",
    "the decode pool's autoscale target replica count (its floor "
    "when the pool is fixed-size)")


def _record_postmortem(reason: str, engine, err) -> None:
    """Failure-path flight-recorder hook: persist the bundle and count
    it; never raises."""
    from tpulab_torch.obs import flightrec

    if flightrec.record_postmortem(reason, engine=engine, err=err
                                   ) is not None:
        _C_POSTMORTEMS.inc()


class ShedError(RuntimeError):
    """Load shedding: the request was REJECTED before admission (queue
    at its bound, or the observed queue-wait p99 already blows the
    request's ``deadline_ms``).  The daemon renders it as an error
    frame whose body starts with ``shed retry_after_ms=<int>`` — a
    stable, parseable contract clients (tpulab_torch.loadgen) retry on
    with backoff instead of treating as a hard failure."""

    def __init__(self, retry_after_ms: int, why: str):
        self.retry_after_ms = int(retry_after_ms)
        super().__init__(
            f"shed retry_after_ms={self.retry_after_ms} ({why})")


class RebuildingError(ShedError):
    """Fleet-wide park timed out: every replica of the requested
    config is draining/quarantined/rebuilding, so placement waited
    ``REBUILD_PARK_S`` and gave up.  Rendered as an error frame whose
    body starts with ``rebuilding retry_after_ms=<int>`` — the same
    parseable retry-after contract as shedding (clients back off and
    retry; tpulab_torch.loadgen.SHED_RE matches both), but NOT counted as a
    shed: a rolling restart that briefly parks traffic must not look
    like load shedding in the goodput accounting."""

    def __init__(self, retry_after_ms: int, why: str):
        self.retry_after_ms = int(retry_after_ms)
        # skip ShedError.__init__'s "shed " prefix
        RuntimeError.__init__(
            self, f"rebuilding retry_after_ms={self.retry_after_ms} ({why})")


class PoolRebuildingError(RebuildingError):
    """Pool-scoped park timed out (disaggregated serving): the fleet
    has placeable replicas, but every replica of the POOL the request's
    phase needs (e.g. the prefill pool for a new admission) is
    draining/quarantined/rebuilding.  Rendered as ``rebuilding
    pool=<role> retry_after_ms=<int>`` — the same retry-after contract
    (tpulab_torch.loadgen.SHED_RE tolerates the pool tag), with the
    starved pool named so a client/operator can tell a one-pool
    brownout from a whole-fleet park."""

    def __init__(self, retry_after_ms: int, role: str, why: str):
        self.retry_after_ms = int(retry_after_ms)
        self.role = role
        RuntimeError.__init__(
            self, f"rebuilding pool={role} "
                  f"retry_after_ms={self.retry_after_ms} ({why})")


#: engine -> int8 draft parameter tree, built lazily on the first
#: speculative request a replica serves; weak keys die with the engine
_DRAFTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_DRAFT_BUILD_LOCK = threading.Lock()

#: serializes beam search, the one host-orchestrated single-stream
#: strategy left (many small dispatches; two at once thrash the card's
#: queue); speculative decoding rides the engine's batched verify ticks
_SPEC_LOCK = threading.Lock()


def _draft_for(engine):
    """The int8-quantized decode tree of an engine's model (its
    speculative draft), built once per engine under a lock that no
    decode takes."""
    with _DRAFT_BUILD_LOCK:
        draft = _DRAFTS.get(engine)
        if draft is None:
            from tpulab_torch.models.quant import quantize_decode_params

            draft = quantize_decode_params(engine.model.to_tree(), engine.cfg)
            _DRAFTS[engine] = draft
    return draft


class _StreamBroken(ConnectionError):
    """A chunk-frame sendall failed (possibly mid-write): the wire can
    no longer carry ANY further frame for this request — the connection
    must close without a terminal frame."""


#: write-ahead request journal (tpulab_torch/durability.py), armed by
#: --journal / TPULAB_DAEMON_JOURNAL.  None (the default) keeps the
#: serving path without record appends, resume table or extra
#: on_progress work.
_JOURNAL = None

#: resume-by-rid stream table: durable rid -> _ResumeEntry.  Fed by
#: the journal-armed generate path and by restart recovery; read by
#: the ``resume`` request.  Bounded: once past the cap, the oldest
#: FINISHED entries are evicted (an in-flight stream is never dropped).
_RESUME: "dict" = {}
_RESUME_LOCK = threading.Lock()
_RESUME_CAP = int(os.environ.get("TPULAB_DAEMON_RESUME_CAP", "512"))

#: resume stall bound: a resume handler waiting on a stream that makes
#: no progress for this long gives up with an error frame instead of
#: pinning its connection slot forever
_RESUME_STALL_S = float(
    os.environ.get("TPULAB_DAEMON_RESUME_STALL_S", "600"))


class _ResumeEntry:
    """One request's resumable byte stream: the bytes committed so far
    (the SAME bytes the original connection's chunk frames carried),
    completion state, and the condition resume readers park on.  All
    fields are guarded by ``cond``."""

    __slots__ = ("cond", "buf", "done", "error")

    def __init__(self):
        self.cond = threading.Condition()
        self.buf = bytearray()
        self.done = False
        self.error = None

    def feed(self, chunk: bytes) -> None:
        with self.cond:
            self.buf += chunk
            self.cond.notify_all()

    def finish(self, data: bytes) -> None:
        """Terminal: pin the buffer to the FULL output (byte-equal to
        what incremental feeds accumulated — asserting that equality is
        the durability tests' job, not a hot-path invariant check)."""
        with self.cond:
            self.buf[:] = data
            self.done = True
            self.cond.notify_all()

    def fail(self, why: str) -> None:
        with self.cond:
            self.error = str(why)
            self.done = True
            self.cond.notify_all()


def _resume_register(rid: str) -> _ResumeEntry:
    """Fresh resume entry for ``rid`` (a re-submission under the same
    rid resets the stream — the new run IS the stream now), evicting
    the oldest finished entries past the table cap."""
    entry = _ResumeEntry()
    with _RESUME_LOCK:
        _RESUME[rid] = entry
        if len(_RESUME) > _RESUME_CAP:
            for old_rid, old in list(_RESUME.items()):
                if len(_RESUME) <= _RESUME_CAP:
                    break
                if old is entry:
                    continue
                with old.cond:
                    if old.done:
                        _RESUME.pop(old_rid, None)
    return entry


def _resume_lookup(rid: str):
    with _RESUME_LOCK:
        return _RESUME.get(rid)


class _AdmissionControl:
    """Deadline-aware admission: the recent-window queue-wait p99 that
    ``deadline_ms`` requests are shed against, and the retry-after hint
    of every shed.  ``lock`` is short-held and never across compute."""

    def __init__(self):
        self.lock = threading.Lock()
        # rolling queue-wait snapshot marks for the windowed shed p99
        # [(t_monotonic, cumulative bucket counts)], at most two
        self._qw_marks: list = []

    def _prime_qw_locked(self) -> None:
        """Seed the rolling queue-wait mark (caller holds self.lock):
        shed p99 deltas count from the first serving activity, not
        process start."""
        if not self._qw_marks:
            h = _obs.REGISTRY.get("queue_wait_seconds")
            if h is not None:
                self._qw_marks.append(
                    (time.monotonic(), h.snapshot()["counts"]))

    def prime_queue_wait(self) -> None:
        with self.lock:
            self._prime_qw_locked()

    def _queue_wait_p99_ms(self) -> float:
        """Queue-wait p99 over (roughly) the last
        ``QUEUE_WAIT_WINDOW_S``, so the estimate decays: a congestion
        spell long past cannot shed deadline traffic against an idle
        daemon forever.

        With the history sampler running, the window is a live-ending
        ``Window`` over the history ring (newest edge = a fresh
        snapshot taken HERE, so requests recorded since the last
        sampler tick count), histogram-bucket differencing with reset
        handling included.  Without a sampler (``--metrics-interval 0``,
        direct-service tests, or a sampler gone stale) two rolling
        marks of the histogram's bucket counts, one per window
        boundary, give the same roughly-one-window estimate."""
        h = _obs.REGISTRY.get("queue_wait_seconds")
        if h is None:
            return 0.0
        if _sampler_active():
            # the live end sample carries ONLY this one histogram —
            # this runs under the engine admission condition per
            # deadline-carrying request, and a full Registry.snapshot
            # here would copy every metric in the process per submit
            w = _obs.HISTORY.window(
                QUEUE_WAIT_WINDOW_S,
                end=(time.monotonic(),
                     {"queue_wait_seconds": h.snapshot()}))
            if w is not None:
                return w.percentile("queue_wait_seconds", 0.99) * 1e3
        snap = h.snapshot()
        now = time.monotonic()
        with self.lock:
            # roll: keep at most two marks, one per window boundary
            if not self._qw_marks or (
                    now - self._qw_marks[-1][0] >= QUEUE_WAIT_WINDOW_S):
                self._qw_marks.append((now, snap["counts"]))
                self._qw_marks = self._qw_marks[-2:]
            base = self._qw_marks[0][1]
        delta = [c - b for c, b in zip(snap["counts"], base)]
        if sum(delta) <= 0:
            return 0.0
        return _obs.percentile_from_buckets(h.bounds, delta, 0.99) * 1e3

    def _retry_after_ms(self, p99_ms: Optional[float] = None) -> int:
        """Retry-after hint for a shed response: the recent-window
        queue-wait p99 (what a request would have waited anyway),
        clamped to [50 ms, 5 s]."""
        if p99_ms is None:
            p99_ms = self._queue_wait_p99_ms()
        return int(min(5000.0, max(50.0, p99_ms)))

    def _shed_check(self, engine, deadline_ms) -> None:
        """Deadline-aware admission control (caller holds st.cond):
        once there IS a queue and the recent-window ``queue_wait`` p99
        already exceeds the request's ``deadline_ms`` budget, admitting
        it would only add a request that cannot meet its deadline to
        everyone else's wait — reject with retry-after instead."""
        if deadline_ms is None or not engine.pending:
            return
        p99_ms = self._queue_wait_p99_ms()
        if p99_ms > float(deadline_ms):
            _C_SHED.inc()
            raise ShedError(
                self._retry_after_ms(p99_ms),
                f"queue_wait p99 {p99_ms:.0f}ms exceeds deadline_ms "
                f"{deadline_ms:g}")



_ADMISSION = _AdmissionControl()

#: the counter subset the per-wave serving log line prints, in order —
#: one place, so the log line and the stats/metrics surfaces cannot
#: drift when a counter is added
_WAVE_KEYS = ("requests_done", "tokens_out", "ticks", "admissions",
              "prefill_chunks", "stall_ticks", "prefill_inflight",
              "host_syncs", "h2d_ticks")


def _engine_stats(engine) -> dict:
    """The one snapshot every observability surface reads (the wave log
    line, ``generate_stats`` and the ``metrics`` sum).  It writes no
    gauge: the ``metrics`` handler's summed publish is the one writer."""
    return engine.stats()


def _counters_line(row: dict) -> str:
    """Render the wave-log counter subset (``k=v`` pairs) from a stats
    snapshot — used by the stepper's "[serve] wave done:" line."""
    return " ".join(f"{k}={row[k]}" for k in _WAVE_KEYS if k in row)


# ------------------------------------------------------------------ fleet
#
# The daemon serves each warm config from a fleet of ``REPLICAS``
# identical PagedEngine replicas behind a router (placement policy in
# tpulab_torch/router.py).  Each replica keeps its own condition (engine
# mutex and stepper wakeup), so replica steppers never serialize behind
# each other's device dispatch; waiters instead park on the FLEET's
# condition (``_Fleet.cv``), which is the one LEAF lock of the layer —
# a request that MIGRATES to a healthy peer after a replica failure
# keeps its waiter without re-parenting it between replica conditions.
#
# Lock order (strict, deadlock-free by construction):
#     replica.cond  ->  fleet.cv          (allowed)
#     fleet.cv      ->  replica.cond      (NEVER)
#     replica.cond  ->  other replica.cond (NEVER)
# Paths that need "find the owner, then act on it" read under
# fleet.cv, release, lock the replica, and re-validate.




class _Ticket:
    """One fleet request's waiter handle: the engine ``_Request`` (the
    object itself migrates between replicas, so ``req.out`` streaming
    survives a migration with zero lost or duplicated tokens), the
    current owner replica, the eventual result, and the replay budget
    the request carries ACROSS migrations — every field is guarded by
    the fleet condition."""

    __slots__ = ("req", "replica", "result", "done", "retries",
                 "cancelled", "parked", "twin", "hedge_winner",
                 "is_hedge")

    def __init__(self, req, replica):
        self.req = req
        self.replica = replica      # current owner (None while parked)
        self.result = None
        self.done = False
        self.retries = 0            # replay budget charged per failure
        self.cancelled = False      # waiter abandoned: discard results
        self.parked = False         # awaiting the owner's rebuild
        self.twin = None            # hedge duplicate's ticket
        self.hedge_winner = None    # decided first-token winner
        self.is_hedge = False


class _Replica:
    """One engine replica: its engine + tokenizer, the per-replica
    condition (engine mutex), the ticket table for its in-flight
    requests, and the health/drain state the router places against.

    ``cond``-guarded: engine, tickets, stepper_alive, dead.
    ``fleet.cv``-guarded: health, draining, drain_pending, generation,
    restarts, parked.  ``role`` is fixed at slot creation and survives
    rebuild/retire/revive — a slot never changes pools."""

    def __init__(self, fleet, index, engine, tok,
                 role: str = _router.ROLE_UNIFIED):
        self.fleet = fleet
        self.index = index
        self.scope = f"replica{index}"
        self.role = role
        self.cond = threading.Condition()
        self.engine = engine
        self.tok = tok
        engine.replica_index = index
        engine.fault_scope = self.scope
        # the engine stamps its pool role onto journey marks and
        # slow-log entries — the fleet is the only party that knows
        # which pool a slot serves
        engine.pool_role = role
        if role == _router.ROLE_PREFILL:
            # a prefill-pool engine parks finished prefills for export
            # instead of decoding them (the handoff)
            engine.handoff_at_boundary = True
        self.tickets: dict = {}       # engine req_id -> _Ticket
        self.stepper_alive = False
        #: True between a failure harvest and the rebuild's engine
        #: swap: the engine object is quarantined — no submit, no
        #: stepper may touch it
        self.dead = False
        self.health = _router.ReplicaHealth()
        self.draining = False         # operator drain: no placement
        self.drain_pending = False    # rebuild still owed once idle
        self.generation = 0           # completed rebuilds
        self.restarts = 0             # failure-driven rebuilds
        self.parked: list = []        # tickets awaiting this rebuild
        #: the slot holds no engine (a spot preemption released it) —
        #: fleet.cv-guarded like the rest of the placement state
        self.retired = False
        # per-replica windowed health evidence: the stepper counts every
        # tick and every slow or stalled tick, and the alert engine's
        # ReplicaStallRule differences them over its window — the
        # telemetry the alert-wired SUSPECT transition
        # (ReplicaHealth.note_alert) consumes.  Keyed by the fleet's
        # process-unique fid and the replica index (up to four warm
        # fleets coexist); a rebuilt replica keeps its slot's counters.
        self.c_ticks = _obs.counter(
            f"fleet{fleet.fid}_replica{index}_ticks",
            f"stepper ticks completed by replica {index} of fleet "
            f"{fleet.fid}")
        self.c_slow_ticks = _obs.counter(
            f"fleet{fleet.fid}_replica{index}_slow_ticks",
            f"fleet {fleet.fid} replica {index} stepper ticks that "
            f"were slow or stalled (the router's degradation "
            f"evidence, windowed by the replica_degraded alert rule)")


#: process-unique fleet ids: the per-replica health counters are keyed
#: ``fleet<fid>_replica<i>``, so two warm fleets' same-index replicas
#: never share a degradation signal
_FLEET_FID = _itertools.count()


class _Fleet:
    """N replicas serving one config, plus the fleet condition every
    waiter parks on.  ``builder`` is the cold-build recipe shared by
    all replicas (``_build_engine`` closure for daemon fleets; tests
    inject their own)."""

    def __init__(self, builder, key=None, stamp=None):
        self.builder = builder
        self.key = key
        self.stamp = stamp
        self.fid = next(_FLEET_FID)
        self.cv = threading.Condition()
        self.replicas: list = []
        self.tok = None
        # the elastic fleet: the telemetry-driven controller + brownout
        # ladder, armed only when --autoscale-max >= 1 — a disarmed
        # fleet is the fixed-size fleet (the sampler hook and the
        # admission hooks all guard on None)
        self.autoscaler = None
        self.brownout = None
        self.scaling = False          # one reconcile op in flight (cv)
        # disaggregated serving: pool table keyed by role —
        # {"min": int, "max": int, "policy": AutoscalePolicy|None} per
        # role from --pool-spec.  Empty on a unified fleet: placement
        # stays phase-blind and all the handoff machinery stays inert.
        self.pools: dict = {}
        if AUTOSCALE_MAX >= 1:
            from tpulab_torch import autoscale as _autoscale

            self.autoscaler = _autoscale.AutoscalePolicy(
                AUTOSCALE_MIN, AUTOSCALE_MAX)
            self.brownout = _autoscale.BrownoutLadder(
                token_cap=BROWNOUT_TOKEN_CAP)

    def add(self, engine, tok,
            role: str = _router.ROLE_UNIFIED) -> "_Replica":
        r = _Replica(self, len(self.replicas), engine, tok, role=role)
        self.replicas.append(r)
        if self.tok is None:
            self.tok = tok
        return r

    # the elastic surface: thin delegations so the policy loop (and
    # tests) drive fleet shape through the fleet object; the mechanics
    # (locking, migration, release) live on _FleetService.
    def add_replica(self, role: Optional[str] = None) -> int:
        """Scale-out: spawn + warm a fresh replica (or revive a
        retired slot through the rebuild lifecycle, replaying any
        stragglers a preemption parked there) and place it into
        service.  ``role`` pins the new capacity to one pool on a
        disaggregated fleet.  Blocking — run it from a reconcile
        thread."""
        return _FLEET_SERVICE.scale_out(self, role=role)

    def retire_replica(self, index: Optional[int] = None,
                       deadline_s: Optional[float] = None,
                       role: Optional[str] = None):
        """Scale-in: drain the least-loaded replica (or ``index``),
        migrate its in-flight requests to peers (greedy streams
        bit-identical), release its engine.  Returns the retired
        index, or None when nothing is retirable (floor of one
        serving replica)."""
        return _FLEET_SERVICE.scale_in(self, index,
                                       deadline_s=deadline_s,
                                       role=role)


def _parse_pool_spec(spec: str) -> list:
    """Parse a ``--pool-spec`` string into ``[(role, min, max), ...]``.

    Syntax: comma-separated ``role=N`` (fixed size) or ``role=MIN..MAX``
    (independently autoscaled between the bounds), roles from
    ``router.ROLES`` — e.g. ``prefill=1..2,decode=1``.  Order is the
    replica-index assignment order.  Raises ValueError on an unknown
    role, a duplicate role, or a non-positive/inverted range."""
    pools = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        role, eq, rng = part.partition("=")
        role = role.strip()
        if not eq or role not in _router.ROLES:
            raise ValueError(
                f"pool spec {part!r}: expected role=N or role=MIN..MAX "
                f"with role in {_router.ROLES}")
        if any(r == role for r, _, _ in pools):
            raise ValueError(f"pool spec: duplicate role {role!r}")
        try:
            if ".." in rng:
                lo, hi = rng.split("..", 1)
                mn, mx = int(lo), int(hi)
            else:
                mn = mx = int(rng)
        except ValueError:
            raise ValueError(
                f"pool spec {part!r}: bounds must be integers") from None
        if mn < 1 or mx < mn:
            raise ValueError(
                f"pool spec {part!r}: need 1 <= MIN <= MAX")
        pools.append((role, mn, mx))
    if not pools:
        raise ValueError("pool spec is empty")
    return pools


def _make_fleet(builder, n: int, key=None, stamp=None,
                pools=None) -> _Fleet:
    fleet = _Fleet(builder, key=key, stamp=stamp)
    if pools is None and POOL_SPEC:
        pools = _parse_pool_spec(POOL_SPEC)
    if pools:
        # disaggregated fleet: MIN replicas per pool in spec order;
        # each ranged pool gets its OWN policy off its own burn signal
        # (queue-wait p99 for prefill — admission pressure; ITL p99
        # for decode — the latency the pool exists to protect)
        from tpulab_torch import autoscale as _autoscale
        for role, mn, mx in pools:
            pol = None
            if mx > mn:
                pol = _autoscale.AutoscalePolicy(
                    mn, mx,
                    latency_high_s=(POOL_ITL_HIGH_S
                                    if role == _router.ROLE_DECODE
                                    else None))
            fleet.pools[role] = {"min": mn, "max": mx, "policy": pol}
            for _ in range(mn):
                eng, tok = builder()
                fleet.add(eng, tok, role=role)
        return fleet
    for _ in range(max(1, int(n))):
        eng, tok = builder()
        fleet.add(eng, tok)
    return fleet


class _FleetService:
    """Fleet-grade continuous batching: placement, health, migration,
    drain, and hedged retries over a :class:`_Fleet`.

    A single stepper thread per replica advances all its slots under
    the replica condition.  A crashed replica's in-flight requests are
    resubmitted on a healthy peer (``PagedEngine.resubmit``) while the
    crashed replica rebuilds in the background and rejoins, so a single
    replica failure does not stall every rider behind one rebuild."""

    def __init__(self):
        self.lock = threading.Lock()   # the _FLEETS registry lock

    # ---------------------------------------------------------- placement
    def _views(self, fleet: _Fleet, prompt, exclude) -> list:
        views = []
        with fleet.cv:
            cand = [(r, r.health.placeable and not r.draining,
                     r.health.state == _router.SUSPECT, r.role)
                    for r in fleet.replicas if r.index not in exclude]
        lost = []
        for r, placeable, suspect, role in cand:
            if not placeable:
                continue
            with r.cond:
                if r.dead:
                    continue
                eng = r.engine
                try:
                    if getattr(eng, "lost", False):
                        raise RankDied("the mesh engine's ranks are gone")
                    load = len(eng.pending) + sum(
                        1 for a in eng.active if a is not None)
                    affinity = 0
                    if prompt is not None and len(prompt) > 1:
                        # shared-prefix blocks already resident in THIS
                        # replica's cache (the LRU freshen is harmless —
                        # the entry IS being matched)
                        affinity = len(eng._lookup_prefix(prompt)[0])
                except RankDied as err:
                    # a mesh engine whose ranks are gone is not placeable;
                    # with no stepper to meet the failure, it fails here
                    if not r.stepper_alive:
                        r.stepper_alive = True
                        lost.append((r, eng, err))
                    continue
            views.append(_router.ReplicaView(
                r.index, True, suspect, load, affinity, role=role))
        for r, eng, err in lost:
            threading.Thread(target=self._fail_replica, args=(r, eng, err),
                             daemon=True).start()
        return views

    def _place(self, fleet: _Fleet, prompt, exclude=frozenset(),
               phase: Optional[str] = None) -> Optional[_Replica]:
        idx = _router.choose_replica(
            self._views(fleet, prompt, exclude), phase=phase)
        return None if idx is None else fleet.replicas[idx]

    @staticmethod
    def _entry_phase(fleet: _Fleet) -> Optional[str]:
        """Placement phase for a request ENTERING the fleet — a fresh
        submit or any replay/migration, both of which start with a
        prefill: the prefill pool on a disaggregated fleet (the work
        hands off at the phase boundary like any other admission, so
        decode replicas never run long prefills), phase-blind
        otherwise."""
        return _router.ROLE_PREFILL if fleet.pools else None

    # ---------------------------------------------------------- submission
    def _ensure_stepper_locked(self, replica: _Replica) -> None:
        """Spawn the replica's stepper if dead (caller holds
        replica.cond): the flag only clears inside the locked idle
        check, so a submitter can never observe a dead-but-flagged-alive
        stepper."""
        if not replica.stepper_alive:
            replica.stepper_alive = True
            threading.Thread(
                target=self._step_loop, args=(replica, replica.engine),
                daemon=True).start()

    def _try_submit(self, fleet: _Fleet, replica: _Replica, prompt,
                    steps: int, kw: dict, deadline_ms, req_rid, tag):
        """Submit on one replica; returns the ticket, ``"full"`` on a
        bounded-queue rejection, or None when the replica became
        unplaceable between scoring and submit (caller re-places).
        Raises ShedError on a blown deadline budget."""
        from tpulab_torch.models.paged import QueueFullError

        draft = None
        for _ in range(2):
            with replica.cond:
                if replica.dead:
                    return None
                with fleet.cv:
                    if not (replica.health.placeable
                            and not replica.draining):
                        return None
                eng = replica.engine
                if (kw.get("spec") == "draft"
                        and eng.draft is None and draft is None):
                    pass  # build the int8 draft OUTSIDE the condition
                else:
                    _ADMISSION._shed_check(eng, deadline_ms)
                    try:
                        eng.submit(prompt, max_new=steps, rid=req_rid,
                                   tag=tag, **kw)
                    except QueueFullError:
                        return "full"
                    except RankDied:
                        return None  # placement fails the lost engine
                    req = eng.pending[-1]
                    tkt = _Ticket(req, replica)
                    replica.tickets[req.req_id] = tkt
                    self._ensure_stepper_locked(replica)
                    return tkt
            draft = _draft_for(eng)
            with replica.cond:
                if replica.engine is not eng:
                    return None  # swapped mid-build: re-place
                if eng.draft is None:
                    eng.set_draft(draft, eng.cfg)
        return None

    def _submit(self, fleet: _Fleet, prompt, steps: int, kw: dict,
                deadline_ms, req_rid, tag, exclude=frozenset(),
                park: bool = True) -> _Ticket:
        """Place and submit one request: best replica by router score;
        a bounded-queue rejection tries the next-best before shedding;
        a fleet with NO placeable replica (rolling restart's worst
        case) parks up to ``REBUILD_PARK_S`` on the fleet condition,
        then answers the parseable ``rebuilding retry_after_ms=N``
        frame clients retry on.  On a disaggregated fleet admissions
        place into the PREFILL pool, and a park that times out with
        the fleet's OTHER pools still placeable answers the
        pool-scoped ``rebuilding pool=<role> retry_after_ms=N``
        frame instead — same client retry contract, sharper
        operator signal."""
        deadline = time.monotonic() + REBUILD_PARK_S
        phase = self._entry_phase(fleet)
        full: set = set()
        while True:
            replica = self._place(fleet, prompt, exclude | full,
                                  phase=phase)
            if replica is None:
                if self._place(fleet, prompt, exclude,
                               phase=phase) is not None:
                    # placeable replicas exist but every queue is at
                    # its bound: backpressure, exactly like the
                    # single-engine QueueFullError shed
                    _C_SHED.inc()
                    if req_rid is not None:
                        _obs.event("daemon.shed", req_rid)
                    raise ShedError(
                        _ADMISSION._retry_after_ms(),
                        "every placeable replica is at max_pending")
                # pool-scoped starvation: the needed pool has zero
                # placeable replicas while the rest of the fleet is
                # fine (phase-blind placement would still land)
                pool_only = (phase is not None and self._place(
                    fleet, prompt, exclude) is not None)
                if not park:
                    if pool_only:
                        raise PoolRebuildingError(
                            _ADMISSION._retry_after_ms(), phase,
                            "no placeable replica in pool")
                    raise RebuildingError(
                        _ADMISSION._retry_after_ms(),
                        "no placeable replica")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if pool_only:
                        raise PoolRebuildingError(
                            _ADMISSION._retry_after_ms(), phase,
                            "pool draining/rebuilding")
                    raise RebuildingError(
                        _ADMISSION._retry_after_ms(),
                        "no placeable replica (fleet "
                        "draining/rebuilding)")
                with fleet.cv:
                    fleet.cv.wait(min(remaining, 0.25))
                full.clear()  # queues may have drained while parked
                continue
            try:
                got = self._try_submit(fleet, replica, prompt, steps,
                                       kw, deadline_ms, req_rid, tag)
            except ShedError:
                # deadline shedding (_shed_check counted it): the
                # trace event rides the caller-allocated rid
                if req_rid is not None:
                    _obs.event("daemon.shed", req_rid)
                raise
            if got == "full":
                full.add(replica.index)
                continue
            if got is None:
                continue  # replica flipped unplaceable: re-place
            return got

    def _finish_locked(self, tkt: _Ticket, out) -> None:
        """Publish a ticket's result (caller holds fleet.cv and
        notifies).  An abandoned ticket's output is discarded."""
        if tkt.cancelled:
            return
        tkt.result = out
        tkt.done = True

    def _finish_error_locked(self, tkt: _Ticket, err: Exception) -> None:
        if tkt.cancelled:
            return
        tkt.result = err
        tkt.done = True

    def _step_loop(self, replica: _Replica, eng) -> None:
        fleet = replica.fleet
        try:
            last_stall = eng.counters["stall_ticks"]
            while True:
                if _faults.ACTIVE:
                    # spot-preemption drill: a "preempt" rule on this
                    # site is the cloud's preemption notice — ``arg`` milliseconds to drain.  Handled
                    # outside the condition (the drain takes it), and
                    # the stepper exits: the replica is being released.
                    rule = _faults.fire("replica.preempt", replica.scope)
                    if rule is not None and rule.kind == "preempt":
                        self._preempt_replica(
                            replica, rule.arg or 2000.0)
                        return
                published = []
                handoffs = []
                with replica.cond:
                    if _faults.ACTIVE:
                        _faults.fire("daemon.step", replica.scope)
                    if (not eng.pending and not eng.inflight_depth
                            and not any(
                                r is not None for r in eng.active)):
                        # clear INSIDE the locked region (submitters
                        # either see alive-and-running or dead-and-
                        # respawn, never a dead flag-alive); the print
                        # happens outside the lock
                        replica.stepper_alive = False
                        row = _engine_stats(eng)
                        break
                    t0 = time.monotonic()
                    for rid_e in eng.step():
                        out = eng._done.pop(rid_e)
                        tkt = replica.tickets.pop(rid_e, None)
                        if tkt is not None:
                            published.append((tkt, out))
                    if getattr(eng, "handoff_ready", None):
                        # the tick parked finished prefills for export —
                        # pull the KV payloads (d2h) and detach the
                        # tickets while the engine mutex is held; the
                        # decode-side placement/import runs OUTSIDE it
                        # (fleet.cv is a leaf, and the import takes the
                        # TARGET replica's condition)
                        for hreq, payload in eng.export_handoff():
                            htkt = replica.tickets.pop(
                                hreq.req_id, None)
                            if htkt is not None:
                                handoffs.append((htkt, payload))
                    dt = time.monotonic() - t0
                    stall = eng.counters["stall_ticks"]
                    stalled = stall != last_stall
                    last_stall = stall
                    # build-driven slowness is expected (cold start) and
                    # watched by the recompile tripwire: only steady-
                    # state slow ticks count as degradation evidence
                    steady = getattr(eng, "_steady", True)
                # health evidence: one counter add per tick (self-locked,
                # no condition held)
                replica.c_ticks.inc()
                if steady and (stalled
                               or dt >= replica.health.slow_tick_s):
                    replica.c_slow_ticks.inc()
                with fleet.cv:
                    # health evidence + publication + the per-tick
                    # wakeup streaming waiters ride (the fleet.cv is a
                    # leaf: taking it while holding nothing is safe,
                    # and the stepper holds nothing here)
                    replica.health.note_tick(dt, stalled)
                    for tkt, out in published:
                        self._finish_locked(tkt, out)
                    fleet.cv.notify_all()
                for htkt, payload in handoffs:
                    self._handoff_one(fleet, replica, htkt, payload)
            print(f"[serve] replica{replica.index} wave done: "
                  + _counters_line(row), flush=True)
            self._maybe_drain_rebuild(replica)
        except Exception as e:
            try:
                self._fail_replica(replica, eng, e)
            except Exception:
                traceback.print_exc()

    # ----------------------------------------------------- failure handling
    def _fail_replica(self, replica: _Replica, eng, err: Exception):
        """A replica's step loop died: quarantine it, publish what the
        failed step already banked, then MIGRATE the in-flight set onto
        healthy peers (park on this replica's rebuild only when no peer
        is placeable — the fleet-of-one case, a rebuild in place).  Each
        failure charges every survivor one replay against
        ``REPLAY_BUDGET`` — the SAME budget whether the replay lands
        here or on a peer, so a request bounced around a failing fleet
        surfaces its failure instead of looping."""
        import numpy as np

        fleet = replica.fleet
        _C_RESTARTS.inc()
        # bundle the evidence before the harvest mutates the engine
        _record_postmortem("replica_quarantine", eng, err)
        with fleet.cv:
            replica.restarts += 1
            replica.health.note_crash()
        with replica.cond:
            banked = list(eng._done.items())
            eng._done.clear()
            survivors = list(eng.pending) + [
                r for r in eng.active if r is not None]
            eng.pending.clear()
            eng.active = [None] * eng.slots
            eng._inflight.clear()  # dead device buffers
            if getattr(eng, "handoff_ready", None):
                # parked handoff slots are harvested as survivors via
                # active above — the export queue entries are stale
                eng.handoff_ready.clear()
            tickets = dict(replica.tickets)
            replica.tickets = {}
            replica.stepper_alive = False
            replica.dead = True
        migrate = []
        n_failed = 0
        with fleet.cv:
            for rid_e, out in banked:
                tkt = tickets.pop(rid_e, None)
                if tkt is not None:
                    self._finish_locked(tkt, out)
            for req in survivors:
                tkt = tickets.pop(req.req_id, None)
                if tkt is None:
                    continue
                if tkt.cancelled:
                    # the waiter abandoned (possibly AFTER the failure):
                    # never migrate a request nobody will consume
                    continue
                if req.cancelled:
                    # waiter alive but already satisfied (early stop):
                    # complete with the tokens it has
                    self._finish_locked(tkt, np.asarray(req.out, np.int32))
                    continue
                tkt.retries += 1
                if tkt.retries > REPLAY_BUDGET or fleet.builder is None:
                    self._finish_error_locked(tkt, err)
                    n_failed += 1
                    continue
                migrate.append(tkt)
            fleet.cv.notify_all()
        n_migrated = n_parked = 0
        for tkt in migrate:
            try:
                migrated_ok = self._migrate(fleet, tkt, {replica.index})
            except Exception as mig_err:  # noqa: BLE001 — one bad
                # ticket must not strand the rest of the harvest: its
                # waiter gets the error, the loop keeps migrating
                with fleet.cv:
                    self._finish_error_locked(tkt, mig_err)
                    fleet.cv.notify_all()
                n_failed += 1
                continue
            if migrated_ok:
                n_migrated += 1
            else:
                # no placeable peer: park for THIS replica's rebuild
                with fleet.cv:
                    tkt.parked = True
                    tkt.replica = None
                    replica.parked.append(tkt)
                n_parked += 1
        if fleet.builder is not None:
            with fleet.cv:
                replica.health.note_rebuild_start()
            threading.Thread(target=self._rebuild, args=(replica,),
                             daemon=True).start()
        print(f"[serve] replica{replica.index} failed "
              f"({type(err).__name__}: {err}): migrated {n_migrated}, "
              f"parked {n_parked}, failed {n_failed} request(s)",
              flush=True)

    def _migrate(self, fleet: _Fleet, tkt: _Ticket, exclude) -> bool:
        """Resubmit one harvested request on the best healthy peer;
        False when no peer is placeable (caller parks).  On a
        disaggregated fleet every migration re-enters at the PREFILL
        pool (a migrated request starts with a re-prefill of its
        committed prefix, and that work belongs to the prefill pool —
        it hands off at the boundary like any fresh admission)."""
        tried = set(exclude)
        phase = self._entry_phase(fleet)
        while True:
            target = self._place(fleet, tkt.req.prompt, tried,
                                 phase=phase)
            if target is None:
                return False
            if self._resubmit_on(target, tkt, migrated=True):
                return True
            tried.add(target.index)

    def _resubmit_on(self, replica: _Replica, tkt: _Ticket,
                     migrated: bool, handoff: bool = False,
                     payload=None) -> bool:
        """Resume a harvested request on ``replica`` via
        ``PagedEngine.resubmit(fresh_id=True)`` (the peer's id space is
        independent of the failed engine's).  Greedy streams stay
        bit-identical to a fault-free run and sampled streams resume
        their per-slot key chain — resubmit's own contract, now applied
        across engines.  Returns False if the replica can't take it
        (died/unplaceable in the meantime).

        ``handoff=True`` marks the prefill→decode handoff (the
        request's NORMAL path on a disaggregated fleet, not a failure:
        counted under ``daemon_handoffs``, no replay/migrate charge);
        ``payload`` is the exported digest-keyed KV block list, seeded
        into the target's host-spill tier under its condition right
        before the resubmit so admission's spill prefetch restores the
        prefix instead of recomputing it."""
        import numpy as np

        fleet = replica.fleet
        with fleet.cv:
            if tkt.cancelled:
                return True  # dropped: nothing to replay for
            req = tkt.req
            satisfied = req.cancelled
        if satisfied:
            with fleet.cv:
                self._finish_locked(tkt, np.asarray(tkt.req.out, np.int32))
                fleet.cv.notify_all()
            return True
        draft = None
        if req.spec == "draft":
            with replica.cond:
                eng = replica.engine
                need = (not replica.dead and eng.spec_k
                        and eng.draft is None)
            if need:
                # a replayed dense-draft request needs the peer's int8
                # draft installed up front; built OUTSIDE the condition
                draft = _draft_for(eng)
        with replica.cond:
            if replica.dead:
                return False
            with fleet.cv:
                if not replica.health.placeable:
                    return False
            eng = replica.engine
            if draft is not None and eng.draft is None and eng.spec_k:
                eng.set_draft(draft, eng.cfg)
            if req.spec != "off" and not eng.spec_k:
                # peer without spec capability: degrade to plain ticks
                # — greedy streams are identical either way
                req.spec = "off"
            try:
                nbytes = 0
                if handoff:
                    # journey: the cross-pool transfer window closes when
                    # the decode engine starts importing; the import phase
                    # closes when the spill puts return.  The payload size
                    # is measured ONCE here — the same nbytes the
                    # handoff_bytes counter ingests below — so journey
                    # bytes and the counter can be compared exactly.
                    _obs.JOURNEY.mark(req.rid, "handoff_import_begin",
                                      replica=replica.index,
                                      pool=replica.role)
                    if payload:
                        nbytes = eng.import_handoff(payload)
                    t_imp = time.monotonic()
                    _obs.JOURNEY.mark(req.rid, "handoff_import", t=t_imp,
                                      replica=replica.index,
                                      pool=replica.role, nbytes=nbytes)
                    req.handoff_bytes += nbytes
                    if req.t_prefill_done:
                        # park -> import-complete wall time: the slow-log
                        # handoff_ms field, and by construction the sum of
                        # the journey's three handoff phases
                        req.handoff_ms = round(
                            (t_imp - req.t_prefill_done) * 1e3, 3)
                elif payload:
                    nbytes = eng.import_handoff(payload)
                try:
                    rid_e = eng.resubmit(req, fresh_id=True)
                except ValueError:
                    # an early-stop cancel raced past the satisfied check
                    # above (resubmit refuses cancelled requests — and the
                    # cancel path's parked branch sets the flag without
                    # this replica's condition): complete with the tokens
                    # the request already has, exactly like the satisfied
                    # path
                    rid_e = None
            except RankDied:
                return False  # placement fails the lost engine
            if rid_e is not None:
                replica.tickets[rid_e] = tkt
                self._ensure_stepper_locked(replica)
        if rid_e is None:
            with fleet.cv:
                self._finish_locked(tkt, np.asarray(tkt.req.out, np.int32))
                fleet.cv.notify_all()
            return True
        with fleet.cv:
            tkt.replica = replica
            tkt.parked = False
            if handoff:
                _C_HANDOFFS.inc()
                if nbytes:
                    _C_HANDOFF_BYTES.inc(nbytes)
                _obs.event("daemon.handoff", tkt.req.rid)
            elif migrated:
                tkt.req.migrations += 1
                _C_MIGRATIONS.inc()
                _obs.event("daemon.migrate", tkt.req.rid)
                _obs.JOURNEY.mark(tkt.req.rid, "migrate",
                                  replica=replica.index,
                                  pool=replica.role)
            else:
                _C_REPLAYS.inc()
                _obs.event("daemon.replay", tkt.req.rid)
                _obs.JOURNEY.mark(tkt.req.rid, "replay",
                                  replica=replica.index,
                                  pool=replica.role)
            fleet.cv.notify_all()
        return True

    def _handoff_one(self, fleet: _Fleet, replica: _Replica,
                     tkt: _Ticket, payload) -> None:
        """Complete one prefill→decode handoff collected from
        ``replica``'s stepper: fire the ``daemon.handoff`` chaos site,
        seed the exported KV payload into the best decode-pool
        replica's host-spill tier, and resume the stream there through
        the resubmit path (no replay-budget charge — a handoff is the
        request's normal path on a disaggregated fleet).

        On an injected crash — or a decode pool with no importable
        target — the payload is DROPPED and the request replays from
        its journaled prompt through the ordinary migration path,
        charging the replay budget exactly like a replica failure:
        zero leaked blocks on either engine (the export already
        released the prefill side's blocks; the import never
        landed)."""
        import numpy as np

        req = tkt.req
        with fleet.cv:
            if tkt.cancelled:
                return
            if req.cancelled:
                # early-stopped between park and export: complete with
                # the tokens it has (the export skipped the d2h)
                self._finish_locked(tkt, np.asarray(req.out, np.int32))
                fleet.cv.notify_all()
                return
        try:
            if _faults.ACTIVE:
                _faults.fire("daemon.handoff", replica.scope)
            # the payload left the prefill engine (export released its
            # blocks) and is now in flight toward a decode placement
            _obs.event("handoff.transfer", req.rid)
            tried = {replica.index}
            while True:
                target = self._place(fleet, req.prompt, tried,
                                     phase=_router.ROLE_DECODE)
                if target is None:
                    break
                try:
                    ok = self._resubmit_on(target, tkt, migrated=False,
                                           handoff=True,
                                           payload=payload)
                except Exception:  # noqa: BLE001 — a bad import on
                    # one target must not crash the PREFILL stepper
                    # that collected the handoff: try the next peer,
                    # fall through to the replay path when none take
                    traceback.print_exc()
                    ok = False
                if ok:
                    return
                tried.add(target.index)
        except _faults.InjectedFault as err:
            print(f"[serve] handoff of rid={req.rid} crashed ({err}); "
                  f"replaying from the journaled prompt", flush=True)
        # the KV payload is lost (crash) or unplaceable (decode pool
        # draining/rebuilding): replay from the prompt the ticket
        # still journals, charging the replay budget so a flapping
        # handoff path surfaces its failure instead of looping
        with fleet.cv:
            if tkt.cancelled:
                return
            tkt.retries += 1
            over = tkt.retries > REPLAY_BUDGET
            if over:
                self._finish_error_locked(tkt, RuntimeError(
                    f"handoff replay budget exhausted for "
                    f"rid={req.rid}"))
                fleet.cv.notify_all()
                return
        if not self._migrate(fleet, tkt, set()):
            with fleet.cv:
                tkt.parked = True
                tkt.replica = None
                replica.parked.append(tkt)

    def _rebuild(self, replica: _Replica) -> None:
        """Background rebuild of a quarantined/drained replica from the
        fleet's builder recipe; on success the fresh engine swaps in,
        the generation advances, and any parked requests replay into
        it.  The cold build runs outside every lock — in-flight decode
        on the healthy replicas never stalls behind it."""
        fleet = replica.fleet
        try:
            eng, tok = fleet.builder()
        except Exception as build_err:
            with fleet.cv:
                replica.health.note_rebuild_failed()
                parked = list(replica.parked)
                replica.parked = []
                for tkt in parked:
                    self._finish_error_locked(tkt, build_err)
                fleet.cv.notify_all()
            print(f"[serve] replica{replica.index} rebuild FAILED: "
                  f"{build_err}", flush=True)
            return
        eng.replica_index = replica.index
        eng.fault_scope = replica.scope
        eng.pool_role = replica.role        # the slot's role survives
        if replica.role == _router.ROLE_PREFILL:
            eng.handoff_at_boundary = True
        with replica.cond:
            replica.engine = eng
            replica.tok = tok
            replica.tickets = {}
            replica.dead = False
        with fleet.cv:
            replica.generation += 1
            replica.health.note_rebuilt()
            parked = list(replica.parked)
            replica.parked = []
            fleet.cv.notify_all()
        for tkt in parked:
            try:
                if not self._resubmit_on(replica, tkt, migrated=False):
                    if not self._migrate(fleet, tkt, set()):
                        with fleet.cv:
                            tkt.parked = True
                            tkt.replica = None
                            replica.parked.append(tkt)
            except Exception as replay_err:  # noqa: BLE001 — one bad
                # ticket must not strand the rest of the parked set
                # (the waiters would hang past every client timeout):
                # its waiter gets the error, the loop keeps replaying
                with fleet.cv:
                    self._finish_error_locked(tkt, replay_err)
                    fleet.cv.notify_all()
        print(f"[serve] replica{replica.index} rebuilt (generation "
              f"{replica.generation}, {len(parked)} parked request(s) "
              f"replayed)", flush=True)

    # ------------------------------------------------------- elastic fleet
    def scale_out(self, fleet: _Fleet,
                  role: Optional[str] = None) -> Optional[int]:
        """Add serving capacity: revive a retired slot through the
        rebuild lifecycle (replaying any stragglers a preemption
        parked there) when one exists, else spawn + append a fresh
        replica.  ``role`` pins the capacity to one pool on a
        disaggregated fleet (only a matching retired slot revives; a
        fresh spawn joins that pool).  Blocking (a cold build); the
        autoscale loop runs it from a reconcile thread, never the
        sampler tick itself."""
        slot = None
        with fleet.cv:
            for r in fleet.replicas:
                if r.retired and (role is None or r.role == role):
                    slot = r
                    r.retired = False
                    r.draining = False
                    r.drain_pending = False
                    r.health.note_rebuild_start()
                    break
        if slot is not None:
            self._rebuild(slot)  # build outside locks, swap, replay
        else:
            if fleet.builder is None:
                return None
            eng, tok = fleet.builder()
            with fleet.cv:
                slot = fleet.add(eng, tok,
                                 role=role or _router.ROLE_UNIFIED)
                fleet.cv.notify_all()
        _C_SCALE_OUTS.inc()
        _obs.event("daemon.scale_out", slot.index)
        print(f"[serve] scale-out: replica{slot.index} in service",
              flush=True)
        return slot.index

    def scale_in(self, fleet: _Fleet, index: Optional[int] = None, *,
                 deadline_s: Optional[float] = None,
                 role: Optional[str] = None) -> Optional[int]:
        """Retire one replica: ``index`` when given, else the least-
        loaded placeable one (ties to the HIGHEST index — replica 0
        stays the fleet's stable anchor).  Refuses to drop below one
        serving replica fleet-wide, and — with ``role`` given — below
        the pool's configured MIN (each pool keeps its floor so the
        other pool's idle period can never starve this one's phase).
        Returns the retired index, or None when nothing is
        retirable."""
        with fleet.cv:
            serving = [r for r in fleet.replicas if not r.retired]
            if len(serving) <= 1:
                return None
            if role is not None:
                floor = max(1, fleet.pools.get(role, {}).get("min", 1))
                if sum(1 for r in serving if r.role == role) <= floor:
                    return None
            if index is not None:
                cand = [r for r in serving if r.index == index]
            else:
                cand = [r for r in serving
                        if r.health.placeable and not r.draining
                        and (role is None or r.role == role)]
        if index is None:
            # loads read under each replica's own condition AFTER the
            # fleet snapshot (the fleet.cv -> replica.cond order is
            # forbidden), exactly like placement's _views
            scored = []
            for r in cand:
                with r.cond:
                    if r.dead:
                        continue
                    eng = r.engine
                    load = len(eng.pending) + sum(
                        1 for a in eng.active if a is not None)
                scored.append((load, -r.index, r))
            if not scored:
                return None
            scored.sort(key=lambda t: (t[0], t[1]))
            victim = scored[0][2]
        elif cand:
            victim = cand[0]
        else:
            return None
        self._retire(fleet, victim, deadline_s=deadline_s)
        _C_SCALE_INS.inc()
        _obs.event("daemon.scale_in", victim.index)
        return victim.index

    def _preempt_replica(self, replica: _Replica,
                         deadline_ms: float) -> None:
        """A spot-preemption NOTICE landed on this replica (the
        ``replica.preempt`` fault site, fired from its own stepper
        thread): migrate what the drain deadline allows, park the
        stragglers, release the engine.  Unlike scale-in there is no
        serving floor — the cloud does not ask; with the autoscaler
        armed the next reconcile revives the slot (replaying the
        parked set), and with the journal armed the client resume
        path covers a straggler either way."""
        _C_SPOT_PREEMPTIONS.inc()
        _obs.event("daemon.preempt", replica.index)
        print(f"[serve] replica{replica.index} spot-preemption "
              f"notice: {deadline_ms:g}ms to drain", flush=True)
        self._retire(replica.fleet, replica,
                     deadline_s=deadline_ms / 1e3, from_stepper=True)

    def _retire(self, fleet: _Fleet, replica: _Replica,
                deadline_s: Optional[float] = None,
                from_stepper: bool = False) -> dict:
        """Drain-migrate-release one replica — the graceful sibling of
        ``_fail_replica``: the same harvest and the same migration
        path (greedy streams stay bit-identical on the peer), but no
        quarantine, no post-mortem, and no replay-budget charge — a
        retirement is not a failure.  ``deadline_s`` bounds the
        migration loop (a preemption notice's drain budget); requests
        still unmigrated at the deadline park on the slot.  ``from_stepper`` marks the
        call as coming from the replica's OWN stepper thread (the
        preempt drill), which exits right after; otherwise the
        harvest leaves a live stepper to observe the emptied engine
        and exit on its own before the engine is released."""
        import numpy as np

        deadline = (None if deadline_s is None
                    else time.monotonic() + deadline_s)
        with fleet.cv:
            replica.draining = True   # placement stops immediately
            replica.drain_pending = False
        with replica.cond:
            eng = replica.engine
            banked = list(eng._done.items())
            eng._done.clear()
            survivors = list(eng.pending) + [
                r for r in eng.active if r is not None]
            eng.pending.clear()
            eng.active = [None] * eng.slots
            eng._inflight.clear()  # in-flight device work: recomputed
            # on the peer from the committed prefix (bit-identical)
            if getattr(eng, "handoff_ready", None):
                eng.handoff_ready.clear()  # harvested via active above
            tickets = dict(replica.tickets)
            replica.tickets = {}
            replica.dead = True
            if from_stepper:
                replica.stepper_alive = False
        if not from_stepper:
            # bounded wait for a live stepper to observe the emptied
            # engine and exit — the engine must not be released under
            # a mid-tick stepper
            end = time.monotonic() + 30.0
            while time.monotonic() < end:
                with replica.cond:
                    if not replica.stepper_alive:
                        break
                time.sleep(0.005)
        migrate = []
        with fleet.cv:
            for rid_e, out in banked:
                tkt = tickets.pop(rid_e, None)
                if tkt is not None:
                    self._finish_locked(tkt, out)
            for req in survivors:
                tkt = tickets.pop(req.req_id, None)
                if tkt is None or tkt.cancelled:
                    continue
                if req.cancelled:
                    # early-stopped: complete with the tokens it has
                    self._finish_locked(
                        tkt, np.asarray(req.out, np.int32))
                    continue
                migrate.append(tkt)
            fleet.cv.notify_all()
        n_migrated = 0
        stragglers = []
        for pos, tkt in enumerate(migrate):
            if deadline is not None and time.monotonic() >= deadline:
                # drain budget blown: everything left parks
                stragglers.extend(migrate[pos:])
                break
            try:
                ok = self._migrate(fleet, tkt, {replica.index})
            except Exception as mig_err:  # noqa: BLE001 — one bad
                # ticket must not strand the rest of the drain
                with fleet.cv:
                    self._finish_error_locked(tkt, mig_err)
                    fleet.cv.notify_all()
                continue
            if ok:
                n_migrated += 1
            else:
                stragglers.append(tkt)  # no peer capacity: park
        with fleet.cv:
            for tkt in stragglers:
                tkt.parked = True
                tkt.replica = None
                replica.parked.append(tkt)
        # release: the engine reference drops here — block pools,
        # prefix cache, and device buffers free with it
        with replica.cond:
            replica.engine = None
        with fleet.cv:
            replica.retired = True
            replica.draining = False  # retired supersedes drain
            replica.health.note_retired()
            fleet.cv.notify_all()
        print(f"[serve] replica{replica.index} retired: migrated "
              f"{n_migrated}, parked {len(stragglers)} request(s)",
              flush=True)
        return {"migrated": n_migrated, "parked": len(stragglers)}


    def drain(self, fleet: _Fleet, index: int) -> dict:
        """Stop placement on one replica; once it quiesces (pending,
        active, and in-flight all empty) it REBUILDS from the recipe —
        the hot-restart primitive a zero-shed rolling restart composes
        from.  Idempotent; counted once per drain edge."""
        replica = fleet.replicas[index]
        with fleet.cv:
            fresh = not replica.draining
            replica.draining = True
            if fresh:
                # arm the rebuild on the drain EDGE only: a repeated
                # drain request must not re-rebuild an already-drained
                # replica (idempotency)
                replica.drain_pending = True
                _C_DRAINS.inc()
                _obs.event("daemon.drain", index)
        self._maybe_drain_rebuild(replica)
        return self.replica_status(replica)

    def undrain(self, fleet: _Fleet, index: int) -> dict:
        """Return a drained replica to placement (its rebuild, if one
        was owed and ran, stays — generation advanced)."""
        replica = fleet.replicas[index]
        with fleet.cv:
            replica.draining = False
            replica.drain_pending = False
            fleet.cv.notify_all()
        return self.replica_status(replica)

    def _maybe_drain_rebuild(self, replica: _Replica) -> None:
        """Kick the drain-owed rebuild if the replica is idle (called
        from the stepper's idle exit and from the drain request — the
        two moments quiescence can first hold)."""
        fleet = replica.fleet
        start = False
        with replica.cond:
            eng = replica.engine
            idle = (not replica.stepper_alive and not replica.dead
                    and not eng.pending and not eng.inflight_depth
                    and not any(r is not None for r in eng.active))
            if idle:
                with fleet.cv:
                    if (replica.draining and replica.drain_pending
                            and replica.health.state
                            != _router.REBUILDING):
                        replica.health.note_rebuild_start()
                        replica.drain_pending = False
                        start = True
        if start and fleet.builder is not None:
            threading.Thread(target=self._rebuild, args=(replica,),
                             daemon=True).start()

    # --------------------------------------------------------------- status
    def replica_status(self, replica: _Replica) -> dict:
        fleet = replica.fleet
        with fleet.cv:
            row = {"replica": replica.index,
                   "role": replica.role,
                   "health": replica.health.state,
                   "suspects": replica.health.suspects,
                   "crashes": replica.health.crashes,
                   "draining": replica.draining,
                   "retired": replica.retired,
                   "generation": replica.generation,
                   "restarts": replica.restarts,
                   "parked": len(replica.parked)}
        with replica.cond:
            row["dead"] = replica.dead
            eng = replica.engine
            if getattr(eng, "rank_pids", None) is not None:
                row["ranks"] = list(eng.rank_pids)  # a mesh replica's processes
            if not replica.dead:
                row["pending"] = len(eng.pending)
                row["active"] = sum(
                    1 for a in eng.active if a is not None)
                row["requests_done"] = eng.counters["requests_done"]
                row["tokens_out"] = eng.counters["tokens_out"]
        return row

    def fleet_status(self, fleet: _Fleet) -> dict:
        with fleet.cv:
            active = sum(1 for r in fleet.replicas if not r.retired)
        out = {"replicas": len(fleet.replicas),
               "active": active,
               "replica": [self.replica_status(r)
                           for r in fleet.replicas]}
        # the elastic surface, when armed (snapshot() reads are
        # sampler-thread-written ints/lists — same tolerance as the
        # admission-path ladder reads)
        if fleet.autoscaler is not None:
            out["autoscale"] = fleet.autoscaler.snapshot()
        if fleet.brownout is not None:
            out["brownout"] = fleet.brownout.snapshot()
        if fleet.pools:
            out["pools"] = {
                role: {"min": p["min"], "max": p["max"],
                       "autoscale": (None if p["policy"] is None
                                     else p["policy"].snapshot())}
                for role, p in fleet.pools.items()}
        return out

    # -------------------------------------------------------------- hedging
    def _decide_winner_locked(self, tkt: _Ticket):
        """First-token-wins resolution (caller holds fleet.cv): before
        any hedge exists the primary IS the winner; with a twin racing,
        the first ticket to produce a token (or finish cleanly) wins —
        primary preferred on a tie, both-failed surfaces the primary's
        error.  None while the race is still open."""
        twin = tkt.twin
        if twin is None:
            return tkt
        if tkt.hedge_winner is not None:
            return tkt.hedge_winner
        p_err = tkt.done and isinstance(tkt.result, Exception)
        h_err = twin.done and isinstance(twin.result, Exception)
        if (tkt.done or len(tkt.req.out) > 0) and not p_err:
            return tkt
        if (twin.done or len(twin.req.out) > 0) and not h_err:
            return twin
        if p_err and h_err:
            return tkt
        return None

    def _fire_hedge(self, fleet: _Fleet, tkt: _Ticket, prompt,
                    steps: int, kw: dict, req_rid, tag) -> None:
        """Duplicate a straggler (no first token inside its hedge
        budget) onto a second replica.  The duplicate is a full ticket
        with the same wire rid/tag (one linked trace tree); the loser
        of the first-token race is cancelled with its blocks released
        through the engine's normal cancel path."""
        with fleet.cv:
            if (tkt.done or tkt.cancelled or tkt.twin is not None
                    or len(tkt.req.out) > 0):
                return
            cur = tkt.replica
            exclude = {cur.index} if cur is not None else set()
        try:
            twin = self._submit(fleet, prompt, steps, kw, None,
                                req_rid, tag,
                                exclude=frozenset(exclude), park=False)
        except ShedError:
            return  # no healthy capacity to hedge into: not an error
        with fleet.cv:
            twin.is_hedge = True
            tkt.twin = twin
            _C_HEDGES.inc()
            if req_rid is not None:
                _obs.event("daemon.hedge", req_rid)
            fleet.cv.notify_all()

    # ------------------------------------------------------------ cancelling
    def _engine_cancel(self, fleet: _Fleet, tkt: _Ticket,
                       mark: bool) -> None:
        """Cancel a ticket's request engine-side.  ``mark=True``
        abandons it (results discarded — the waiter is gone);
        ``mark=False`` is the early-stop path (waiter alive; the
        request finishes through the NORMAL path next tick so block
        accounting releases exactly).  Migration can move the request
        between the lookup and the cancel — re-validate and retry
        against the new owner (bounded: a request only migrates while
        replicas are actively failing)."""
        import numpy as np

        for _ in range(64):
            with fleet.cv:
                if mark:
                    tkt.cancelled = True
                    tkt.result = None
                    tkt.done = False
                if tkt.done:
                    return
                rep = tkt.replica
                if tkt.parked or rep is None:
                    # parked for a rebuild: the resubmit path honors
                    # the flags (cancelled -> dropped; req.cancelled ->
                    # completed with the tokens it has)
                    if not mark:
                        tkt.req.cancelled = True
                    return
            finish_now = False
            with rep.cond:
                # the id is only meaningful while THIS ticket owns it
                # on THIS replica: after a migrate-away + rebuild the
                # fresh engine's counter can reissue the same small
                # integer to a stranger, and cancelling by raw id
                # would kill the stranger's request
                if (not rep.dead
                        and rep.tickets.get(tkt.req.req_id) is tkt):
                    try:
                        where = rep.engine.cancel(tkt.req.req_id)
                    except RankDied:
                        # the lost engine's harvest honours the flag
                        tkt.req.cancelled = True
                        return
                    if where == "pending":
                        rep.tickets.pop(tkt.req.req_id, None)
                        finish_now = not mark
            if finish_now:
                # early stop caught the request queued (a migration
                # window): nothing will ever publish it — complete
                # with the tokens produced so far
                with fleet.cv:
                    self._finish_locked(
                        tkt, np.asarray(tkt.req.out, np.int32))
                    fleet.cv.notify_all()
                return
            with fleet.cv:
                if tkt.done or tkt.parked or tkt.replica is rep:
                    return
            # migrated between reads: retry on the new owner

    # ------------------------------------------------------------- generate
    def generate(self, fleet: _Fleet, prompt, steps: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 repetition_penalty: float = 1.0, stop_byte: int = -1,
                 spec: str = "off", spec_k: int = 0, spec_ngram: int = 0,
                 deadline_ms=None, priority: int = 0, req_rid=None,
                 tag: str = "", hedge_ms: float = 0.0,
                 on_progress=None):
        """Block until the request finishes somewhere in the fleet;
        returns the full token array.  ``on_progress(new_tokens)``, if
        given, is called with each tick's new tokens outside every
        lock; a truthy return cancels the request (early stop) and the
        tokens so far are returned.  Router placement, transparent
        migration on replica failure, deadline shedding, and hedged
        retries (``hedge_ms`` > 0: no first token inside the budget
        fires a duplicate on a second replica, first token wins, the
        loser is cancelled)."""
        import numpy as np

        prompt = np.asarray(prompt, np.int32).reshape(-1)
        kw = dict(temperature=temperature, seed=seed,
                  repetition_penalty=repetition_penalty,
                  stop_byte=stop_byte, spec=spec, spec_k=spec_k,
                  spec_ngram=spec_ngram, priority=priority)
        _ADMISSION.prime_queue_wait()
        tkt = self._submit(fleet, prompt, steps, kw, deadline_ms,
                           req_rid, tag)
        hedge_at = None
        if hedge_ms and len(fleet.replicas) > 1:
            hedge_at = time.monotonic() + float(hedge_ms) / 1e3
        sent = 0
        stopped = False
        try:
            while True:
                fire_hedge = False
                loser = None
                with fleet.cv:
                    while True:
                        win = self._decide_winner_locked(tkt)
                        if win is not None and win.done:
                            break
                        if (win is not None and on_progress is not None
                                and not stopped
                                and len(win.req.out) > sent):
                            break
                        timeout = None
                        if hedge_at is not None and tkt.twin is None:
                            timeout = hedge_at - time.monotonic()
                            if timeout <= 0:
                                fire_hedge = True
                                break
                        fleet.cv.wait(timeout)
                    if (tkt.twin is not None and win is not None
                            and tkt.hedge_winner is None):
                        # first token (or clean finish) decides the
                        # race exactly once; the loser is cancelled
                        # OUTSIDE the fleet condition
                        tkt.hedge_winner = win
                        loser = tkt.twin if win is tkt else tkt
                        if win is not tkt:
                            _C_HEDGE_WINS.inc()
                    done = win is not None and win.done
                    result = win.result if done else None
                    inc = []
                    if (win is not None and on_progress is not None
                            and not stopped):
                        inc = list(win.req.out[sent:])
                        sent = len(win.req.out)
                if loser is not None:
                    self._engine_cancel(fleet, loser, mark=True)
                if fire_hedge:
                    hedge_at = None  # one hedge per request
                    self._fire_hedge(fleet, tkt, prompt, steps, kw,
                                     req_rid, tag)
                    continue
                if inc and on_progress is not None:
                    if on_progress(inc) and not done and not stopped:
                        stopped = True
                        # early stop: finish through the NORMAL path
                        # (result still publishes; admission's block
                        # count releases exactly)
                        self._engine_cancel(fleet, win, mark=False)
                if done:
                    if isinstance(result, Exception):
                        raise RuntimeError(
                            f"engine step failed: {result!r}"
                        ) from result
                    return result
        except BaseException:
            # the waiter is abandoning (typically: a streaming client
            # died inside on_progress) — discard results, cancel the
            # request (and any hedge twin) wherever it currently lives
            with fleet.cv:
                twin = tkt.twin
            self._engine_cancel(fleet, tkt, mark=True)
            if twin is not None:
                self._engine_cancel(fleet, twin, mark=True)
            raise


_FLEET_SERVICE = _FleetService()

#: (realpath|None, attn, kv_dtype, prefill_chunk, tp, mesh) -> (stamp, fleet);
#: LRU, max 4 — room for one checkpoint's knob variants plus a second
#: checkpoint
_FLEETS: "dict" = {}


def _ckpt_stamp(ckpt_dir: str):
    """Cheap CHANGE DETECTOR, not a step parser: the largest
    integer-named subdirectory.  Compared against the stamp taken when
    the engine loaded, never against the snapshot format's own notion of
    its newest step."""
    try:
        steps = [
            int(e) for e in os.listdir(ckpt_dir)
            if e.isdigit() and os.path.isdir(os.path.join(ckpt_dir, e))
        ]
    except OSError:
        return None
    return max(steps) if steps else None



def _canon_mesh(spec: str) -> str:
    """A ``--mesh``/``{"mesh"}`` spec in its cache-key form (``"02x4"`` is
    ``"2x4"``); ``""`` for no mesh and for ``"1x1"``, one device."""
    if not spec:
        return ""
    from tpulab_torch.parallel.mesh import parse_mesh_spec

    b, m = parse_mesh_spec(spec)
    return f"{b}x{m}" if b * m > 1 else ""


def _mesh_axes(tp: int, mesh_spec: str):
    """The serving mesh's axes of a recipe, its spec canonical (None: one
    device)."""
    if mesh_spec:
        b, m = (int(v) for v in mesh_spec.split("x"))
        return {"batch": b, "model": m}
    if tp > 1:
        return {"tp": tp}
    return None


def _engine_knobs(attn: str, kv_dtype: str, prefill_chunk: int) -> dict:
    """The ``PagedEngine`` knobs of every serving engine the daemon builds."""
    return dict(
        slots=4, n_blocks=128, block_size=16,
        max_seq=_SERVE_MAX_SEQ, attn=attn, kv_dtype=kv_dtype,
        # chunked prefill by default, interleaved with decode ticks
        prefill_chunk=prefill_chunk,
        # speculation capability costs nothing until a speculative
        # request arrives; verify windows run the gather path, so the
        # daemon keeps tpulab's gather-only offer
        spec_k=_SPEC_K if attn == "gather" else 0,
        # bounded admission queue: backpressure instead of growth
        max_pending=MAX_PENDING,
        prefix_index=PREFIX_INDEX,
        spill_blocks=SPILL_BLOCKS,
        spill_dtype=SPILL_DTYPE,
    )


def _build_engine(path, attn: str, kv_dtype: str, prefill_chunk: int,
                  tp: int = 1, mesh_spec: str = ""):
    """Cold-build one serving engine from its recipe (checkpoint
    realpath and serving knobs) on the daemon's device.  A checkpoint's
    sidecar is honoured (its config replaces the demo config, LoRA
    adapters fold before serving, and its BPE tokenizer is returned);
    without one the demo model's random weights from seed 0 serve.  On a
    mesh (``mesh_spec`` ``"AxB"`` over more than one device, or ``tp``
    above 1) the engine is built in every rank of a rank pool on the
    daemon's device type, and a :class:`~tpulab_torch.parallel.mesh_engine.
    MeshEngine` drives it.  The recipe is left on the engine
    (``_rebuild``, ``_build_key``, ``_build_stamp``) for the supervisor
    and the flight recorder."""
    from tpulab_torch.models.generate import load_sidecar, serving_params
    from tpulab_torch.models.paged import PagedEngine
    from tpulab_torch.runtime.device import resolve_device

    device = resolve_device(BACKEND)
    knobs = _engine_knobs(attn, kv_dtype, prefill_chunk)
    axes = _mesh_axes(tp, mesh_spec)
    if axes is not None:
        from tpulab_torch.parallel.mesh_engine import MeshEngine

        _, tok = load_sidecar(path)
        engine = MeshEngine(axes, path, device_type=device.type, **knobs)
    else:
        params, cfg, tok = serving_params(path)
        engine = PagedEngine(params, cfg, device=device, **knobs)
    engine._build_key = (path, attn, kv_dtype, prefill_chunk, tp, mesh_spec)
    engine._build_stamp = _ckpt_stamp(path) if path else None
    engine._rebuild = lambda: _build_engine(path, attn, kv_dtype, prefill_chunk, tp,
                                            mesh_spec)
    return engine, tok


def _fleet_for(ckpt, attn: str = "gather", kv_dtype: str = "native",
               prefill_chunk: Optional[int] = None, tp: int = 1,
               mesh_spec: str = "") -> _Fleet:
    """The warm :class:`_Fleet` (``REPLICAS`` engines and the tokenizer)
    of a serving config.  Keys are (realpath, attn, kv_dtype,
    prefill_chunk, tp, mesh): ``ckpts`` and ``./ckpts`` alias, and engines
    built with different knobs never collide.  A newer checkpoint step
    evicts the stale fleet, at most 4 stay resident (LRU), and only the
    dict lookups hold the registry lock: the cold build runs outside it,
    so in-flight decode on other fleets never stalls behind a load (a lost
    build race reuses the winner's fleet)."""
    if prefill_chunk is None:
        prefill_chunk = PREFILL_CHUNK
    mesh_spec = _canon_mesh(mesh_spec)
    path = os.path.realpath(ckpt) if ckpt else None
    key = (path, attn, kv_dtype, prefill_chunk, tp, mesh_spec)
    stamp = _ckpt_stamp(path) if path else None
    with _FLEET_SERVICE.lock:
        hit = _FLEETS.get(key)
        if hit is not None and hit[0] == stamp:
            _FLEETS[key] = _FLEETS.pop(key)  # LRU freshen
            return hit[1]
    fleet = _make_fleet(
        lambda: _build_engine(path, attn, kv_dtype, prefill_chunk, tp, mesh_spec),
        REPLICAS, key=key, stamp=stamp)
    with _FLEET_SERVICE.lock:
        hit = _FLEETS.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]  # concurrent build won; use theirs
        _FLEETS.pop(key, None)
        _FLEETS[key] = (stamp, fleet)
        while len(_FLEETS) > 4:
            _FLEETS.pop(next(iter(_FLEETS)))
    return fleet


def _decode_out(tok, out, stop_byte: int) -> bytes:
    """Terminal response bytes from an engine token stream: the
    byte-LM or BPE decode and the stop-byte cut."""
    if tok is None:
        return bytes(int(t) & 0xFF for t in out)
    data = tok.decode([int(t) for t in out])
    if stop_byte >= 0:
        cut = data.find(bytes([stop_byte]))
        if cut >= 0:
            data = data[: cut + 1]  # include the stop byte, like the
            # byte-LM path (engine stops right AFTER emitting it)
    return data



def _handle_generate(header: dict, payload: bytes,
                     send_chunk=None) -> bytes:
    """``generate`` pseudo-lab: payload = UTF-8 prompt bytes (the byte
    LM's tokens), response = generated continuation bytes.

    The model and its fleet stay warm across requests, so repeated
    system prompts hit the engines' prefix caches.  Config keys:
    ``steps`` (default 64), ``ckpt_dir`` (a checkpoint in the port's
    format; default random demo weights), ``temperature`` + ``seed``
    (default greedy), ``repetition_penalty`` (1.0 = off), ``stop_byte``
    (finish right after emitting it; -1 = off), ``stream`` (status-2
    chunk frames), ``attn``/``kv_dtype`` (engine knobs),
    ``prefill_chunk`` (default ``PREFILL_CHUNK``; 0 = the whole prompt
    at admission), ``speculative`` + ``draft_k`` (lossless greedy
    speculation with a lazily built int8 draft), ``prompt_lookup`` +
    ``lookup_ngram`` (draft-free n-gram speculation) — both batch
    through the shared engine's verify ticks — ``deadline_ms``
    (queue-wait shedding: a ``shed retry_after_ms=N`` error frame),
    ``priority`` (KV-pressure preemption rank), ``tag`` (echoed in the
    slow log), ``hedge_ms``, ``beams`` (beam search of that width,
    outside the engine under ``_SPEC_LOCK``, unstreamed), ``mesh``
    (``"AxB"``: serve over a batch x model mesh; default ``MESH_SPEC``)
    and ``tp`` (serve over a legacy 1-D tp mesh of that many devices;
    exclusive with ``mesh``).  On a mesh, greedy bytes equal one
    device's; ``attn='pallas'``, ``beams`` and the dense-draft
    ``speculative`` are refused there, as ``tpulab`` refuses them, and so
    is a mesh wider than the daemon's device type has devices, all before
    any engine is built."""
    import numpy as np

    config = header.get("config") or {}
    steps = int(config.get("steps", 64))
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if not payload:
        # reject before paying model/engine construction on a cold cache
        raise ValueError("empty prompt")
    stop_byte = int(config.get("stop_byte", -1))
    if stop_byte > 255:
        # a stop BYTE is a byte in any token space; reject before the
        # engine build is paid
        raise ValueError(f"stop_byte must be in [-1, 255], got {stop_byte}")
    # serving knobs (PagedEngine validates values; this surfaces typos
    # before a cold engine build is paid)
    attn = str(config.get("attn", "gather"))
    kv_dtype = str(config.get("kv_dtype", "native"))
    if attn not in ("gather", "pallas"):
        raise ValueError(f"attn={attn!r}; expected 'gather' or 'pallas'")
    if kv_dtype not in ("native", "int8"):
        raise ValueError(
            f"kv_dtype={kv_dtype!r}; expected 'native' or 'int8'")
    tp = int(config.get("tp", 1))
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    # the 2-D serving mesh "AxB" (batch x model), a per-request override of
    # the daemon-wide --mesh; validated here so a typo never pays a cold
    # build, and exclusive with the legacy 1-D tp knob (two ways to say
    # "shard the model" on one request is a contradiction, not a merge)
    mesh_spec = str(config.get("mesh", MESH_SPEC) or "")
    if mesh_spec:
        from tpulab_torch.parallel.mesh import parse_mesh_spec

        mesh_b, mesh_m = parse_mesh_spec(mesh_spec)
        if tp > 1:
            raise ValueError(
                "config sets both mesh and tp > 1: the 2D mesh's "
                "model axis IS the tp role — drop one")
        mesh_spec = _canon_mesh(mesh_spec)  # "1x1" is one device
    deadline_ms = config.get("deadline_ms")
    if deadline_ms is not None:
        deadline_ms = float(deadline_ms)
        if not deadline_ms > 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms}")
    priority = int(config.get("priority", 0))
    # per-request tracing identity: the rid is allocated here, before
    # admission, so a shed request's daemon.shed event shares the id its
    # engine events would have carried
    tag = str(config.get("tag", ""))
    req_rid = _obs.next_rid()
    hedge_ms = config.get("hedge_ms", HEDGE_MS)
    hedge_ms = float(hedge_ms) if hedge_ms else 0.0
    if hedge_ms < 0:
        raise ValueError(f"hedge_ms must be >= 0, got {hedge_ms}")
    prefill_chunk = int(config.get("prefill_chunk", PREFILL_CHUNK))
    if prefill_chunk < 0:
        raise ValueError(
            f"prefill_chunk must be >= 0 (0 = whole-prompt dense "
            f"oracle path), got {prefill_chunk}")
    if tp > 1 or mesh_spec:
        # the engine's own mesh refusal, before the cold build is paid:
        # B7 reads one device's pools
        if attn == "pallas":
            raise ValueError("attn='pallas' does not support mesh serving")
        from tpulab_torch.parallel.mesh import device_type_count

        need = tp if tp > 1 else mesh_b * mesh_m
        have = device_type_count(str(BACKEND).lower())
        if have < need:
            raise ValueError(
                f"mesh serving needs {need} devices; this daemon has {have}")
    beams = int(config.get("beams", 0))
    deterministic_combo = (
        float(config.get("temperature", 0.0)) != 0.0
        or float(config.get("repetition_penalty", 1.0)) != 1.0
        or bool(config.get("stream"))
    )
    # config-only errors: reject before a cold engine build is paid.
    # Speculation rides the engine's verify ticks; sampling refuses it
    # (a sampled slot would silently fall back to single-token ticks)
    sampled = float(config.get("temperature", 0.0)) != 0.0
    if bool(config.get("speculative")) and sampled:
        raise ValueError(
            "speculative decoding is greedy: drop temperature")
    if bool(config.get("prompt_lookup")) and (
        sampled or bool(config.get("speculative"))
    ):
        raise ValueError(
            "prompt_lookup decoding is greedy: drop "
            "temperature/speculative")
    if beams and (deterministic_combo or bool(config.get("speculative"))
                  or bool(config.get("prompt_lookup")) or stop_byte >= 0):
        raise ValueError(
            "beam search is deterministic and unstreamed: drop "
            "temperature/repetition_penalty/stream/speculative/"
            "prompt_lookup/stop_byte")
    if beams < 0:
        raise ValueError(f"beams must be >= 0, got {beams}")
    spec_mode = "off"
    spec_k = 0
    spec_ngram = 0
    if bool(config.get("prompt_lookup")) or bool(config.get("speculative")):
        spec_k = int(config.get("draft_k", 4))
        if spec_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {spec_k}")
        if spec_k > _SPEC_K:
            raise ValueError(
                f"draft_k={spec_k} exceeds the engine verify window "
                f"{_SPEC_K}")
        if attn == "pallas":
            raise ValueError(
                "speculative decoding serves through the gather engine "
                "(no pallas verify kernel): drop attn='pallas'")
        if bool(config.get("prompt_lookup")):
            spec_mode = "lookup"
            spec_ngram = int(config.get("lookup_ngram", 3))
            if spec_ngram < 1:
                raise ValueError(
                    f"lookup_ngram must be >= 1, got {spec_ngram}")
        else:
            spec_mode = "draft"
    if (tp > 1 or mesh_spec) and beams:
        # beam search runs its own loop on one model, outside the engine
        # decode path a mesh serves
        raise ValueError(
            "mesh serving covers the engine decode path only: drop "
            "beams or the mesh/tp knob")
    if (tp > 1 or mesh_spec) and bool(config.get("speculative")):
        # prompt_lookup rides the mesh's verify ticks; the dense-draft
        # proposer has no sharding
        raise ValueError(
            "speculative (dense-draft) decoding is uncertified on "
            "mesh serving: use prompt_lookup or drop the mesh/tp knob")
    fleet = _fleet_for(config.get("ckpt_dir"), attn, kv_dtype, prefill_chunk, tp,
                       mesh_spec)
    # brownout ladder: degrade NEW admissions by the currently-engaged
    # rungs.  All four apply after parse/validation (a browned-out
    # request still had to be well-formed) and before any engine work.
    # Reads are lock-free on purpose: the ladder's level is a single int
    # mutated only by the sampler tick, and an admission racing a rung
    # transition is equivalent to arriving one tick earlier/later.
    ladder = fleet.brownout
    if ladder is not None and ladder.level > 0:
        if ladder.hedging_disabled:
            hedge_ms = 0.0
        if ladder.spec_disabled:
            spec_mode = "off"
            spec_k = 0
            spec_ngram = 0
        steps = ladder.cap_steps(steps)
        deadline_ms = ladder.tighten_deadline_ms(deadline_ms)
    tok = fleet.tok
    # config reads only: every replica shares the one build recipe, so
    # any live replica's config speaks for the fleet (replica 0 can be a
    # retired slot once the fleet is elastic)
    engine = next((r.engine for r in fleet.replicas
                   if r.engine is not None), None)
    if engine is None:
        raise RuntimeError("fleet has no live replica (all retired)")
    if tok is None:
        prompt = np.frombuffer(payload, np.uint8).astype(np.int32)
        eng_stop = stop_byte
    else:
        # BPE checkpoint: the wire stays raw bytes; ``steps`` counts
        # tokens, and the stop byte is found in the decoded stream
        prompt = np.asarray(tok.encode(bytes(payload)), np.int32)
        eng_stop = -1
    if beams:
        # beam search: a cache-reordering loop with a host backtrack,
        # served outside the batching engine on the engine's model,
        # serialized on its own lock; beams=1 is exactly greedy
        if beams > engine.cfg.vocab:
            raise ValueError(
                f"beams={beams} > vocab {engine.cfg.vocab}")
        if len(prompt) + steps > _SERVE_MAX_SEQ:
            raise ValueError(
                f"prompt + steps = {len(prompt) + steps} exceeds the "
                f"daemon serving cap {_SERVE_MAX_SEQ}")
        from tpulab_torch.models.beam import beam_search

        with _SPEC_LOCK:
            seq, _ = beam_search(engine.model, prompt, steps=steps, beams=beams)
        toks = [int(t) for t in seq]
        if tok is None:
            return bytes(t & 0xFF for t in toks)
        return tok.decode(toks)
    if spec_mode == "draft" and engine.cfg.n_experts:
        raise ValueError(
            "speculative decoding needs an int8 draft; MoE "
            "checkpoints are not quantizable (models/quant.py)")

    # crash durability: with the journal armed, the accept record —
    # rid, tag, prompt payload, the FULL config (which carries the
    # engine build recipe: ckpt_dir/attn/kv_dtype/prefill_chunk) — is
    # fsynced BEFORE admission, so a process death at any later point
    # leaves a replayable request, never a lost one.  The durable rid is
    # the CLIENT's (``config["rid"]`` — the resume-by-rid key it
    # reconnects with); a client that sent none gets a server-generated
    # fallback (journaled for replay, but not client-resumable).
    jnl = _JOURNAL
    entry = None
    drid = None
    if jnl is not None:
        drid = config.get("rid")
        if drid is not None:
            drid = str(drid)
            if not 0 < len(drid) <= 256:
                raise ValueError(
                    "rid must be a non-empty string of at most 256 chars")
        else:
            drid = f"srv-{os.getpid()}-{req_rid}"
        jnl.append_accept(drid, tag, payload, config)
        if _faults.ACTIVE:
            # deterministic process death AFTER the accept record is
            # durable and BEFORE admission — the exact window the
            # journal exists for (kind "kill": os._exit, no cleanup)
            _faults.fire("daemon.kill")
        entry = _resume_register(drid)

    # streaming: each tick's new tokens go out as a status-2 chunk
    # frame (BPE-decoded per increment — token expansions are
    # independent, so chunk boundaries are byte-exact).  Once the stop
    # byte has been streamed on the BPE path (the engine cannot see
    # it) the request is cancelled through the return value.  With the
    # journal armed the SAME closure also runs for non-streaming
    # clients: it feeds the resume entry's byte stream and checkpoints
    # the committed token prefix at the journal's bounded cadence.
    streaming = send_chunk is not None and bool(config.get("stream"))
    on_progress = None
    if streaming or entry is not None:
        state = {"done": False, "toks": []}

        def on_progress(new_tokens):
            if state["done"]:
                return True
            if tok is None:
                chunk = bytes(int(t) & 0xFF for t in new_tokens)
            else:
                chunk = tok.decode([int(t) for t in new_tokens])
            if tok is not None and stop_byte >= 0:
                cut = chunk.find(bytes([stop_byte]))
                if cut >= 0:
                    chunk = chunk[: cut + 1]
                    state["done"] = True
            if entry is not None:
                state["toks"].extend(int(t) for t in new_tokens)
                jnl.note_tokens(drid, state["toks"])
                if chunk:
                    entry.feed(chunk)
            if chunk and streaming:
                send_chunk(chunk)
            return state["done"]

    try:
        out = _FLEET_SERVICE.generate(
            fleet, prompt, steps,
            temperature=float(config.get("temperature", 0.0)),
            seed=int(config.get("seed", 0)),
            repetition_penalty=float(config.get("repetition_penalty", 1.0)),
            stop_byte=eng_stop,
            spec=spec_mode, spec_k=spec_k, spec_ngram=spec_ngram,
            deadline_ms=deadline_ms, priority=priority,
            req_rid=req_rid, tag=tag, hedge_ms=hedge_ms,
            on_progress=on_progress,
        )
    except ShedError:
        if jnl is not None:
            jnl.append_done(drid, "shed")
            entry.fail("shed before admission")
        raise
    except _StreamBroken:
        # the CLIENT died mid-stream while this process stayed healthy:
        # the request was cancelled engine-side, so the journal records
        # a cancellation (recovery must not replay it)
        if jnl is not None:
            jnl.append_done(drid, "cancelled")
            entry.fail("client hung up mid-stream")
        raise
    except BaseException as e:
        if jnl is not None:
            jnl.append_done(drid, "error")
            entry.fail(f"{type(e).__name__}: {e}")
        raise
    data = _decode_out(tok, out, stop_byte)
    if jnl is not None:
        jnl.append_done(drid, "ok", tokens=[int(t) for t in out])
        entry.finish(data)
    return data


def _handle_resume(header: dict, send_chunk=None) -> bytes:
    """``resume`` pseudo-lab: continue a journaled stream by rid.

    Config: ``rid`` (the durable id the client submitted its generate
    with) and ``received`` (how many stream BYTES the client already
    holds).  The daemon streams ``bytes[received:]`` as status-2 chunk
    frames — skipping EXACTLY the acknowledged prefix, so the client
    sees no duplicate and no gap — and answers the terminal frame with
    the FULL output, same shape as a streamed generate.  A recovering
    stream that has not yet regenerated past ``received`` simply waits:
    regeneration is bit-identical (the resubmit contract), so the byte
    offset is stable across the crash.  Unknown rids get a parseable
    error body (``resume unknown rid=...``) — the client's signal to
    fall back to a fresh submission."""
    config = header.get("config") or {}
    rid = config.get("rid")
    if not rid:
        raise ValueError("resume needs config['rid']")
    rid = str(rid)
    received = int(config.get("received", 0))
    if received < 0:
        raise ValueError(f"received must be >= 0, got {received}")
    entry = _resume_lookup(rid)
    if entry is None:
        raise ValueError(f"resume unknown rid={rid}")
    _C_RESUMED_STREAMS.inc()
    _obs.event("daemon.resume", _obs.next_rid())
    stream = send_chunk is not None and bool(config.get("stream", True))
    sent = received
    stall_at = time.monotonic() + _RESUME_STALL_S
    while True:
        with entry.cond:
            while (not entry.done and len(entry.buf) <= sent
                   and time.monotonic() < stall_at):
                entry.cond.wait(0.25)
            chunk = bytes(entry.buf[sent:])
            done = entry.done
            error = entry.error
        if error is not None:
            raise RuntimeError(f"resume rid={rid} failed: {error}")
        if chunk:
            stall_at = time.monotonic() + _RESUME_STALL_S
            if stream:
                send_chunk(chunk)
            sent += len(chunk)
        if done:
            with entry.cond:
                return bytes(entry.buf)
        if not chunk and time.monotonic() >= stall_at:
            raise RuntimeError(
                f"resume rid={rid} stalled: no stream progress in "
                f"{_RESUME_STALL_S:g}s")


def _recovery_params(config: dict) -> dict:
    """The replay-relevant generate knobs, decoded from a journaled
    accept record's config with the SAME defaults ``_handle_generate``
    applies — recovery must re-derive exactly the engine request the
    original admission would have built.  The recipe's ``ckpt_dir``
    names a checkpoint in the port's format (``tpulab_torch-ckpt-v1``,
    :mod:`tpulab_torch.ckpt`)."""
    return dict(
        steps=int(config.get("steps", 64)),
        stop_byte=int(config.get("stop_byte", -1)),
        attn=str(config.get("attn", "gather")),
        kv_dtype=str(config.get("kv_dtype", "native")),
        tp=int(config.get("tp", 1)),
        mesh=_canon_mesh(str(config.get("mesh", MESH_SPEC) or "")),
        prefill_chunk=int(config.get("prefill_chunk", PREFILL_CHUNK)),
        temperature=float(config.get("temperature", 0.0)),
        seed=int(config.get("seed", 0)),
        repetition_penalty=float(config.get("repetition_penalty", 1.0)),
        priority=int(config.get("priority", 0)),
        ckpt_dir=config.get("ckpt_dir"),
    )


def _refinish_completed(e, entry) -> None:
    """A rid that RETIRED before the crash (done record with tokens)
    but whose client may never have read the terminal frame: rebuild
    the response bytes from the journaled token stream so a
    reconnecting client's resume is answered instead of bounced into a
    duplicate submission."""
    try:
        p = _recovery_params(e.accept.get("config") or {})
        fleet = _fleet_for(p["ckpt_dir"], p["attn"], p["kv_dtype"],
                           p["prefill_chunk"], p["tp"], p["mesh"])
        entry.finish(_decode_out(fleet.tok, e.done.get("tokens") or [],
                                 p["stop_byte"]))
    except Exception as err:  # noqa: BLE001 — a failed refinish must
        # surface through the entry, not kill the recovery thread
        entry.fail(f"{type(err).__name__}: {err}")


def _recover_one(journal, rid: str, e, entry) -> None:
    """Replay ONE incomplete journaled request to completion: rebuild
    (or reuse) its fleet from the recorded recipe, seed an engine
    request with the checkpointed committed prefix, and resume through
    ``_resubmit_on`` — the same fold-tokens-into-prompt path the
    supervisor replay and fleet migration run on, so greedy streams are
    bit-identical to an uninterrupted run and sampled streams continue
    their per-slot draw counter."""
    import numpy as np

    from tpulab_torch import durability
    from tpulab_torch.models.paged import _Request

    try:
        config = e.accept.get("config") or {}
        p = _recovery_params(config)
        payload = durability.decode_payload(e.accept.get("payload", ""))
        tag = str(e.accept.get("tag", ""))
        fleet = _fleet_for(p["ckpt_dir"], p["attn"], p["kv_dtype"],
                           p["prefill_chunk"], p["tp"], p["mesh"])
        tok = fleet.tok
        if tok is None:
            prompt = np.frombuffer(payload, np.uint8).astype(np.int32)
            eng_stop = p["stop_byte"]
        else:
            prompt = tok.encode(bytes(payload))
            eng_stop = -1
        req = _Request(
            req_id=-1,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new=p["steps"], temperature=p["temperature"],
            seed=p["seed"],
            repetition_penalty=p["repetition_penalty"],
            stop_byte=eng_stop,
            # spec degrades to plain ticks on recovery: speculative
            # decode is lossless, so the stream is bit-identical either
            # way (the same degrade _resubmit_on applies on a spec-less
            # peer)
            spec="off", spec_k=0,
            priority=p["priority"], rid=_obs.next_rid(), tag=tag)
        req.out = [int(t) for t in (e.ckpt or [])]
        tkt = _Ticket(req, None)
        tkt.parked = True
        deadline = time.monotonic() + 600.0
        while True:
            target = _FLEET_SERVICE._place(fleet, req.prompt, frozenset())
            if target is not None and _FLEET_SERVICE._resubmit_on(
                    target, tkt, migrated=False):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "no placeable replica for journal recovery")
            with fleet.cv:
                fleet.cv.wait(0.25)
        # stream the replay into the resume entry from token 0: the
        # checkpointed prefix regenerates the SAME bytes the original
        # connection already sent, which is exactly what lets a
        # reconnecting client's received-count skip them
        sent = 0
        toks: list = []
        stopped = False
        while True:
            with fleet.cv:
                while not tkt.done and len(req.out) <= sent:
                    fleet.cv.wait(0.5)
                done = tkt.done
                result = tkt.result
                inc = list(req.out[sent:])
                sent = len(req.out)
            if inc and not stopped:
                toks.extend(inc)
                if tok is None:
                    chunk = bytes(int(t) & 0xFF for t in inc)
                else:
                    chunk = tok.decode([int(t) for t in inc])
                if tok is not None and p["stop_byte"] >= 0:
                    cut = chunk.find(bytes([p["stop_byte"]]))
                    if cut >= 0:
                        chunk = chunk[: cut + 1]
                        stopped = True
                if chunk:
                    entry.feed(chunk)
                journal.note_tokens(rid, toks)
                if stopped:
                    _FLEET_SERVICE._engine_cancel(fleet, tkt, mark=False)
            if done:
                if isinstance(result, Exception):
                    raise RuntimeError(
                        f"recovery replay failed: {result!r}"
                    ) from result
                out = result
                break
        journal.append_done(rid, "ok", tokens=[int(t) for t in out])
        entry.finish(_decode_out(tok, out, p["stop_byte"]))
        _C_RECOVERIES.inc()
        _obs.event("daemon.recover", req.rid)
        print(f"[tpulab_torch.daemon] recovered rid={rid} "
              f"({len(out)} token(s))", flush=True)
    except Exception as err:  # noqa: BLE001 — one unrecoverable rid
        # must not kill the thread silently: the entry carries the
        # error to any resuming client, and the journal records it so
        # the NEXT restart does not replay a poisoned request forever
        try:
            journal.append_done(rid, "error")
        except Exception:
            pass
        entry.fail(f"{type(err).__name__}: {err}")
        print(f"[tpulab_torch.daemon] recovery FAILED for rid={rid}: {err}",
              flush=True)


def _recover_from_journal(journal) -> int:
    """Scan the journal (torn final record tolerated), compact it, and
    launch the recovery threads: completed-ok rids re-register their
    finished streams (resume-by-rid answered from the journaled
    tokens); incomplete rids replay to completion.  Registration is
    SYNCHRONOUS — by the time the daemon accepts its first resume
    request every journaled rid is in the table, waiting on its
    recovery thread.  Returns the incomplete count."""
    state = journal.scan()
    if state.torn:
        print("[tpulab_torch.daemon] journal: torn final record ignored",
              flush=True)
    # compact BEFORE the recovery threads start appending fresh
    # records — compaction rewrites from the scanned state, and a
    # concurrent append would be lost in the rewrite
    journal.compact(state)
    for rid, e in state.completed_ok().items():
        entry = _resume_register(rid)
        threading.Thread(target=_refinish_completed, args=(e, entry),
                         daemon=True).start()
    incomplete = state.incomplete()
    for rid, e in incomplete.items():
        entry = _resume_register(rid)
        threading.Thread(target=_recover_one,
                         args=(journal, rid, e, entry),
                         daemon=True).start()
    return len(incomplete)


def _handle_generate_stats(header: dict) -> bytes:
    """Engine observability over the wire: PagedEngine.stats() JSON for
    the requested ckpt_dir's engine (empty object if none is warm).
    Includes the overlap counters — ``host_syncs`` (forced drains of
    the async window), ``h2d_ticks`` (ticks that needed a host upload)
    and ``inflight_depth`` — so the zero-transfer steady state is
    visible in production, not just benches."""
    config = header.get("config") or {}
    with _FLEET_SERVICE.lock:
        fhit = _FLEETS.get(_fleet_key(config))
    # key-wise sum across the fleet's replicas plus the replica count;
    # the per-replica breakdown lives in the ``fleet`` request and the
    # metrics scrape's suffixed gauges.  Each stats() read holds its
    # replica's condition, the lock its stepper takes.
    total: dict = {}
    for r in (fhit[1].replicas if fhit is not None else ()):
        with r.cond:
            if r.dead or r.engine is None:
                continue
            row = _engine_stats(r.engine)
        for k, v in row.items():
            total[k] = total.get(k, 0) + v
    if total:
        total["replicas"] = len(fhit[1].replicas)
    return json.dumps(total).encode("utf-8")


def _fleet_key(config: dict) -> tuple:
    """The ``_FLEETS`` key a request's engine-selection config names."""
    path = config.get("ckpt_dir")
    return (os.path.realpath(path) if path else None,
            str(config.get("attn", "gather")),
            str(config.get("kv_dtype", "native")),
            int(config.get("prefill_chunk", PREFILL_CHUNK)),
            int(config.get("tp", 1)),
            _canon_mesh(str(config.get("mesh", MESH_SPEC) or "")))


#: serializes the engine-gauge rewrite and render inside a ``metrics``
#: scrape — scrapes only, never the serving path.  Re-entrant: the
#: scrape handler holds it across refresh and render.
_METRICS_RENDER_LOCK = threading.RLock()

#: the numbered breakdown suffixes the stale-gauge sweep may zero
#: (engine_<key>_replica<i> / engine_<key>_shard<i>) — never a base
#: gauge whose own name merely ends in "_shard"
_STALE_SUFFIX_RE = re.compile(r"_(?:replica|shard)\d+$")


def _refresh_engine_gauges() -> None:
    """Publish a fresh ``engine_*`` gauge mirror of the warm engines'
    stats() — SUMMED across engines (process-wide totals; identical to
    the single engine's stats in the common case) plus the per-replica
    ``engine_*_replica<i>`` breakdown — through the one gauge-writing
    site, so two warm engines can never overwrite each other into a
    mixed exposition."""
    from tpulab_torch import obs
    from tpulab_torch.models.paged import publish_engine_stats

    with _FLEET_SERVICE.lock:
        fleets = [v[1] for v in _FLEETS.values()]
    total: dict = {}
    per_replica: dict = {}
    all_engines = []
    for fleet in fleets:
        for r in fleet.replicas:
            # the stats read holds the replica's condition, the lock its
            # stepper mutates the engine under
            with r.cond:
                eng = None if r.dead else r.engine
                if eng is None:
                    continue
                st = _engine_stats(eng)
            all_engines.append(eng)
            agg = per_replica.setdefault(r.index, {})
            for k, v in st.items():
                total[k] = total.get(k, 0) + v
                agg[k] = agg.get(k, 0) + v
    # the summed engine footprint the memory gauge falls back to
    from tpulab_torch.obs import roofline as _roofline

    estimate = 0
    per_shard: dict = {}
    n_devices = 1
    for eng in all_engines:
        estimate += eng.device_bytes_estimate()
        # each mesh shard's bytes summed across engines (shard i is device
        # i of its serving mesh, mesh-order); the MFU peak scales by the
        # widest warm mesh, the one the dispatches span
        for i, st in eng.shard_stats().items():
            agg = per_shard.setdefault(i, {})
            for k, v in st.items():
                agg[k] = agg.get(k, 0) + v
        n_devices = max(n_devices, getattr(eng, "_mesh_devices", 1))
    # gauge rewrite + render under ONE scrape lock: the stale-suffix
    # zeroing below is not atomic with the re-publish, so a concurrent
    # scrape rendering mid-rewrite would report a healthy fleet as
    # all-zero replicas next to non-zero totals.  Scrapes serialize
    # against each other only — submits never take this lock.
    with _METRICS_RENDER_LOCK:
        if total:
            publish_engine_stats(total)
            # per-replica breakdown NEXT TO the process-wide sum
            # (engine_<key>_replica<i> — one sick replica stays visible
            # in a scrape instead of vanishing into the total).  Stale
            # suffixed gauges (an evicted fleet's replicas) zero first
            # so they can't freeze their final values into every
            # scrape.
            # suffix match must require the NUMBERED form: the
            # unsuffixed process-wide sum includes gauges whose own
            # names end in "_shard" (engine_kv_pool_bytes_per_shard),
            # and a bare substring test zeroes them right after the
            # publish above
            for name in obs.REGISTRY.names():
                if name.startswith("engine_") and _STALE_SUFFIX_RE.search(
                        name):
                    obs.REGISTRY.get(name).set(0)
            for i, st in sorted(per_replica.items()):
                publish_engine_stats(st, suffix=f"_replica{i}")
            # per-shard breakdown (engine_<key>_shard<i>): same
            # stale-suffix discipline as the replica gauges
            for i, st in sorted(per_shard.items()):
                publish_engine_stats(st, suffix=f"_shard{i}")
        else:
            # no warm engines (none built yet, or the last one was
            # evicted after a stepper failure): zero the mirror instead
            # of freezing the dead engine's final values into every
            # future scrape
            for name in obs.REGISTRY.names():
                if name.startswith("engine_"):
                    obs.REGISTRY.get(name).set(0)
        # device gauges refresh after the engine_* zero/publish pass
        # (the zero loop above matches the engine_ prefix)
        from tpulab_torch.runtime.device import resolve_device

        _roofline.update_device_memory_gauges(estimate, device=resolve_device(BACKEND))
        _roofline.update_mfu_gauges(n_devices=n_devices)


def _handle_metrics(header: dict) -> bytes:
    """``metrics`` request: Prometheus text exposition of the process-
    global registry — the serving latency histograms (ttft_seconds /
    itl_seconds / e2e_seconds / queue_wait_seconds / prefill_seconds)
    and a fresh ``engine_*`` gauge mirror of the warm engines
    (``_refresh_engine_gauges``)."""
    from tpulab_torch import obs

    with _METRICS_RENDER_LOCK:
        _refresh_engine_gauges()
        return obs.render_prometheus().encode("utf-8")


def _handle_compile_stats(header: dict) -> bytes:
    """``compile_stats`` request: the build ledger
    (:mod:`tpulab_torch.obs.compilestats` — each run-time build's count
    and seconds), the card's roofline peaks, and the current
    engine_mfu/train_mfu gauge values as JSON."""
    from tpulab_torch.obs import COMPILESTATS
    from tpulab_torch.obs import roofline as _roofline
    from tpulab_torch.runtime.device import resolve_device

    peaks = _roofline.device_peaks(resolve_device(BACKEND))
    return json.dumps({
        "programs": COMPILESTATS.snapshot(),
        "peaks": peaks,
        "mfu": _roofline.update_mfu_gauges(peaks),
        "steady_recompiles": COMPILESTATS.steady_recompiles,
        "total_compile_seconds": round(
            COMPILESTATS.total_compile_seconds(), 6),
    }).encode("utf-8")


def _handle_postmortem(header: dict) -> bytes:
    """``postmortem`` request: the NEWEST flight-recorder bundle
    (:mod:`tpulab_torch.obs.flightrec`) as JSON, with its on-disk
    ``path`` and the total bundle count; ``{"bundles": 0}`` when none
    exist."""
    from tpulab_torch.obs import flightrec

    bundle = flightrec.latest_postmortem()
    n = len(flightrec.list_bundles())
    if bundle is None:
        return json.dumps({"bundles": 0}).encode("utf-8")
    bundle["bundles"] = n
    return json.dumps(bundle).encode("utf-8")


def _handle_trace_dump(header: dict) -> bytes:
    """``trace_dump`` request: the ring-buffer tracer's retained window
    as Chrome trace-event JSON — load the bytes directly in
    https://ui.perfetto.dev.  Size the window with ``--trace-buffer``."""
    from tpulab_torch import obs

    return json.dumps(obs.TRACER.chrome_trace()).encode("utf-8")


def _handle_slowlog(header: dict) -> bytes:
    """``slowlog`` request: the worst-N requests BY end-to-end latency
    with their span summaries (queue wait / prefill chunks / TTFT /
    worst inter-token gap + the token index it landed on / preemptions
    / resubmits — tpulab_torch.obs.slowlog) as JSON.  Each entry's ``rid``
    links it to the same request's events in a ``trace_dump`` — "p99
    blew the budget" converts into "this request, this tick".  Config:
    ``n`` caps the returned entries (default 10); ``clear`` resets the
    log after the read (a capture run that wants per-window worsts).
    Size the window with ``--slowlog``."""
    from tpulab_torch import obs

    config = header.get("config") or {}
    n = int(config.get("n", 10))
    # one atomic snapshot(+clear): entries and the recorded count come
    # from the same lock acquisition, and under ``clear`` an entry
    # retiring mid-request lands in exactly one window — never in
    # neither, never counted-but-missing
    return json.dumps(
        obs.SLOWLOG.snapshot(n, clear=bool(config.get("clear")))
    ).encode("utf-8")


def _handle_journey(header: dict) -> bytes:
    """``journey`` request: stitched request journeys from
    :data:`tpulab_torch.obs.JOURNEY` — the phase waterfall
    (queue_wait → prefill → handoff export/transfer/import →
    decode_queue → decode) with per-phase wall time, handoff bytes,
    and replica/pool, assembled from the marks every engine and the
    fleet layer dropped for the rid.  Config:

    * ``rid`` — one journey by server rid (the id slow-log entries,
      trace events, and histogram exemplars carry);
    * ``tag`` — one journey by the caller's wire tag (the loadgen
      journal key — newest match wins);
    * neither — the ``n`` newest journeys (default 8), plus store
      stats.  ``completed`` restricts the listing to retired requests.

    Size the store with ``--journeys`` (0 disables)."""
    from tpulab_torch import obs

    config = header.get("config") or {}
    if config.get("rid") is not None:
        j = obs.JOURNEY.snapshot(int(config["rid"]))
        return json.dumps({"journey": j}).encode("utf-8")
    if config.get("tag"):
        j = obs.JOURNEY.find_tag(str(config["tag"]))
        return json.dumps({"journey": j}).encode("utf-8")
    n = int(config.get("n", 8))
    return json.dumps({
        "journeys": obs.JOURNEY.recent(
            n, completed_only=bool(config.get("completed"))),
        "stats": obs.JOURNEY.stats(),
    }).encode("utf-8")


# ---------------------------------------------------------------- sampler
#
# The TIME dimension.  One background sampler per daemon
# process drives the whole telemetry-over-time layer — every
# ``METRICS_INTERVAL_S`` it (1) refreshes the engine gauge mirror so
# the snapshot carries live stats, (2) appends one registry snapshot to
# the history ring, (3) evaluates the alert catalog over the ring's
# windows, and (4) maps each replica's ``replica_degraded`` alert state
# onto the router's health machine — closing the telemetry->control
# loop: a degraded replica is steered away from BEFORE its crash path
# runs.  The sampler never touches an engine condition or the device;
# everything it reads is either the registry (per-metric locks) or the
# fleet table under fleet.cv.

#: the live sampler (serve() starts it; tests drive _sampler_tick
#: directly for determinism)
_SAMPLER = None


def _sampler_active() -> bool:
    """Whether windowed consumers (the shed check) may trust the
    history ring: a sampler is running AND its newest sample is recent
    enough that the window edge is meaningful (a wedged sampler thread
    falls back to the two-mark path instead of shedding on stale data)."""
    s = _SAMPLER
    if s is None or not s.running:
        return False
    age = _obs.HISTORY.age_s()
    return age is not None and age < max(5.0, 5.0 * s.interval_s)


def _ensure_replica_rules() -> None:
    """Lazily install one ``fleet<f>_replica<i>_degraded`` rule per
    replica of every warm fleet (AlertManager.add is idempotent by
    name; rules are fleet-id-scoped so two warm fleets' same-index
    replicas never share a verdict).  Rules for evicted fleets stay —
    their counters stop moving, so the rule goes inactive on its
    own."""
    from tpulab_torch.obs.alerts import ALERTS, ReplicaStallRule

    with _FLEET_SERVICE.lock:
        fleets = [v[1] for v in _FLEETS.values()]
    for fleet in fleets:
        for r in fleet.replicas:
            ALERTS.add(ReplicaStallRule(r.index, fleet_id=fleet.fid))


def _apply_fleet_alerts() -> None:
    """Map each replica's ``replica_degraded`` alert state onto its
    health machine (``ReplicaHealth.note_alert`` under fleet.cv) — the
    alert-wired SUSPECT transition.  FIRING demotes/holds SUSPECT so
    placement steers off the replica; resolution releases the hold and
    the normal clean-tick hysteresis finishes recovery."""
    from tpulab_torch.obs import alerts as _alerts

    with _FLEET_SERVICE.lock:
        fleets = [v[1] for v in _FLEETS.values()]
    for fleet in fleets:
        for r in fleet.replicas:
            st = _alerts.ALERTS.get_state(
                f"fleet{fleet.fid}_replica{r.index}_degraded")
            firing = st is not None and st.state == _alerts.FIRING
            with fleet.cv:
                r.health.note_alert(firing)


#: the FIRING states the autoscaler counts as pressure evidence — the
#: burn-rate rules install_default_rules() always installs
_PRESSURE_ALERTS = ("queue_wait_burn_fast", "ttft_burn_fast",
                    "itl_burn_fast", "e2e_burn_fast",
                    "goodput_shed_burn")


def _fleet_signals(fleet: _Fleet,
                   role: Optional[str] = None) -> "object":
    """Snapshot one :class:`tpulab_torch.autoscale.Signals` for a fleet:
    serving-replica count + summed load under the proper lock order
    (fleet snapshot under fleet.cv, THEN loads under each replica's own
    condition), plus the history-window pressure evidence shared by
    every fleet (the ring is process-global).

    ``role`` scopes the snapshot to one pool of a disaggregated fleet
    and selects that pool's OWN burn signal: the prefill
    pool scales on queue-wait p99 (admission pressure is prefill
    work), the decode pool on ITL p99 (the latency the pool exists to
    protect) — each pool is blind to the other's signal so a prefill
    burst can never scale the decode pool or vice versa."""
    from tpulab_torch import autoscale as _autoscale
    from tpulab_torch.obs import alerts as _alerts

    with fleet.cv:
        live = [r for r in fleet.replicas if not r.retired
                and (role is None or r.role == role)]
        n = len(live)
    load = 0
    for r in live:
        with r.cond:
            if r.dead:
                continue
            eng = r.engine
            load += len(eng.pending) + sum(
                1 for a in eng.active if a is not None)
    qp99 = None
    itl99 = None
    shed_rate = 0.0
    if _sampler_active():
        w = _obs.HISTORY.window(AUTOSCALE_WINDOW_S)
        if w is not None:
            if (role != _router.ROLE_DECODE
                    and w.count("queue_wait_seconds") > 0):
                qp99 = w.percentile("queue_wait_seconds", 0.99)
            if (role == _router.ROLE_DECODE
                    and w.count("itl_seconds") > 0):
                itl99 = w.percentile("itl_seconds", 0.99)
            shed_rate = w.rate("daemon_shed_requests")
    firing = 0
    for name in _PRESSURE_ALERTS:
        st = _alerts.ALERTS.get_state(name)
        if st is not None and st.state == _alerts.FIRING:
            firing += 1
    return _autoscale.Signals(
        active_replicas=max(1, n),
        load_per_replica=load / max(1, n),
        queue_wait_p99_s=qp99,
        shed_rate=shed_rate,
        alerts_firing=firing,
        latency_p99_s=itl99)


def _reconcile_fleet(fleet: _Fleet, target: int,
                     role: Optional[str] = None) -> None:
    """One reconcile step toward ``target`` (a daemon thread, one op
    in flight per fleet): scale OUT when provisioned < target — a
    preempted slot revives this way too, since preemption drops the
    provisioned count below target with no cooldown in the way — and
    scale IN when above.  ``role`` scopes both the count and the op
    to one pool of a disaggregated fleet."""
    try:
        with fleet.cv:
            provisioned = sum(
                1 for r in fleet.replicas if not r.retired
                and (role is None or r.role == role))
        if provisioned < target:
            fleet.add_replica(role=role)
        elif provisioned > target:
            fleet.retire_replica(role=role)
    except Exception:
        traceback.print_exc()
    finally:
        with fleet.cv:
            fleet.scaling = False
            fleet.cv.notify_all()


def _pool_autoscale_tick(fleet: _Fleet, now: float) -> None:
    """One sampler tick of the per-pool control loop: refresh
    the ``pool_*`` gauges, fold each ranged pool's Signals into ITS
    policy, and kick at most one reconcile op for the fleet (the
    ``fleet.scaling`` latch is fleet-wide — pools take turns, which is
    fine: a reconcile is one add/retire and the next tick re-checks).
    Fixed-size pools (``role=N``) publish gauges but never scale."""
    for role, pool in fleet.pools.items():
        with fleet.cv:
            n_live = sum(1 for r in fleet.replicas
                         if not r.retired and r.role == role)
        if role == _router.ROLE_PREFILL:
            _G_POOL_PREFILL_REPLICAS.set(float(n_live))
        elif role == _router.ROLE_DECODE:
            _G_POOL_DECODE_REPLICAS.set(float(n_live))
        pol = pool["policy"]
        if pol is None:
            continue
        sig = _fleet_signals(fleet, role=role)
        target = pol.observe(now, sig)
        if role == _router.ROLE_PREFILL:
            _G_POOL_PREFILL_TARGET.set(float(target))
        elif role == _router.ROLE_DECODE:
            _G_POOL_DECODE_TARGET.set(float(target))
        with fleet.cv:
            provisioned = sum(1 for r in fleet.replicas
                              if not r.retired and r.role == role)
            if not fleet.scaling and provisioned != target:
                fleet.scaling = True
                threading.Thread(
                    target=_reconcile_fleet,
                    args=(fleet, target, role),
                    daemon=True).start()


def _autoscale_tick() -> None:
    """The elastic-fleet control loop, riding the sampler tick: per warm
    fleet, fold one Signals snapshot into the fleet's AutoscalePolicy
    and BrownoutLadder, then kick ONE reconcile op (a background
    thread — the cold build must never run on the sampler thread)
    whenever provisioned != target and no op is already in flight."""
    with _FLEET_SERVICE.lock:
        fleets = [v[1] for v in _FLEETS.values()]
    now = time.monotonic()
    total_target = 0
    max_level = 0
    armed = False
    for fleet in fleets:
        if fleet.pools:
            # a disaggregated fleet's pools scale
            # INDEPENDENTLY, each off its own policy + burn signal
            # (queue-wait for prefill, ITL for decode); the fleet-wide
            # autoscaler/brownout ladder is never armed alongside
            # pools (--pool-spec and --autoscale-max are exclusive)
            _pool_autoscale_tick(fleet, now)
            continue
        pol = fleet.autoscaler
        if pol is None:
            continue
        armed = True
        sig = _fleet_signals(fleet)
        target = pol.observe(now, sig)
        total_target += target
        ladder = fleet.brownout
        if ladder is not None:
            transition = ladder.observe(now, pol.overloaded(sig))
            if transition is not None:
                direction, rung = transition.split(":", 1)
                if direction == "engage":
                    _C_BROWNOUT_STEPS.inc()
                else:
                    _C_BROWNOUT_REVERSALS.inc()
                _obs.event(f"daemon.brownout.{direction}", rung)
                print(f"[serve] brownout {direction}: {rung} "
                      f"(level {ladder.level})", flush=True)
            max_level = max(max_level, ladder.level)
        with fleet.cv:
            provisioned = sum(
                1 for r in fleet.replicas if not r.retired)
            busy = fleet.scaling
            if not busy and provisioned != target:
                fleet.scaling = True
                threading.Thread(
                    target=_reconcile_fleet, args=(fleet, target),
                    daemon=True).start()
    if armed:
        _G_TARGET_REPLICAS.set(float(total_target))
        _G_BROWNOUT_LEVEL.set(float(max_level))


def _sampler_tick() -> None:
    """One sampler iteration's POST-sample hook (the gauge refresh runs
    as the before-hook so the sample itself is fresh): evaluate alerts
    over the ring, wire the verdicts into fleet health, then run the
    elastic-fleet control loop off the same verdicts."""
    _ensure_replica_rules()
    _obs.ALERTS.evaluate(_obs.HISTORY)
    _apply_fleet_alerts()
    _autoscale_tick()


def start_sampler(interval_s: Optional[float] = None,
                  capacity: Optional[int] = None):
    """Build + start the daemon's history sampler (serve() calls this;
    exposed for benches/tests).  Installs the default alert catalog
    with page-severity flight-recorder bundles enabled.  Returns the
    sampler, or None when the interval is 0 (disabled)."""
    global _SAMPLER
    from tpulab_torch.obs import alerts as _alerts
    from tpulab_torch.obs import history as _history

    iv = METRICS_INTERVAL_S if interval_s is None else float(interval_s)
    if iv <= 0:
        return None
    cap = max(1, int(capacity if capacity is not None
                     else HISTORY_CAPACITY))  # a misconfigured env
    # (TPULAB_DAEMON_HISTORY=0) degrades to the smallest ring instead
    # of killing the daemon before it binds its socket
    if _obs.HISTORY.capacity != cap:
        _obs.configure_history(cap)
    _alerts.install_default_rules()
    _alerts.ALERTS.page_postmortems = True
    if _SAMPLER is not None:
        _SAMPLER.stop()
    _SAMPLER = _history.Sampler(
        _obs.HISTORY, iv, on_sample=_sampler_tick,
        before_sample=_refresh_engine_gauges).start()
    return _SAMPLER


def stop_sampler() -> None:
    global _SAMPLER
    if _SAMPLER is not None:
        _SAMPLER.stop()
        _SAMPLER = None


def _handle_history(header: dict) -> bytes:
    """``history`` request: the metrics-over-time report from the ring
    (tpulab_torch.obs.history) as JSON — ring occupancy, one windowed summary
    (per-counter rates, per-histogram windowed counts + percentiles),
    and optional per-metric rate series for sparklines.  Config:
    ``seconds`` (window, default 30), ``series`` (metric names to
    return rate series for), ``series_seconds`` (series span; defaults
    to ``seconds``).  ``python -m tpulab_torch.obs.console`` renders
    it live."""
    config = header.get("config") or {}
    seconds = float(config.get("seconds", 30.0))
    if seconds <= 0:
        raise ValueError(f"seconds must be > 0, got {seconds}")
    series = config.get("series") or ()
    if not isinstance(series, (list, tuple)):
        raise ValueError("series must be a list of metric names")
    ss = config.get("series_seconds")
    report = _obs.HISTORY.report(
        seconds, series=[str(s) for s in series],
        series_seconds=None if ss is None else float(ss))
    s = _SAMPLER
    report["sampler"] = {
        "running": bool(s is not None and s.running),
        "interval_s": None if s is None else s.interval_s,
        "errors": 0 if s is None else s.errors,
    }
    return json.dumps(report).encode("utf-8")


def _handle_alerts(header: dict) -> bytes:
    """``alerts`` request: the alert engine's state table as JSON
    (firing first).  Evaluates the catalog FIRST by default — so
    staleness/absence rules stay live even when the sampler thread
    itself is wedged (exactly the failure ``sampler_stale`` exists
    for); transitions are edge-triggered, so an extra evaluation from
    a request thread never double-counts.  Config ``{"no_evaluate":
    true}`` returns the table as the last sampler tick left it."""
    from tpulab_torch.obs import alerts as _alerts

    config = header.get("config") or {}
    if not config.get("no_evaluate"):
        _alerts.ALERTS.evaluate(_obs.HISTORY)
    return json.dumps(_alerts.ALERTS.snapshot()).encode("utf-8")


def _resolve_fleet(config: dict) -> Optional[_Fleet]:
    """The warm fleet a ``fleet``/``drain``/``undrain`` request
    targets: by the engine-selection keys when any are given (or when
    several fleets are warm), else the single warm fleet — the common
    one-config daemon needs no key juggling from operators."""
    with _FLEET_SERVICE.lock:
        fleets = dict(_FLEETS)
    if not fleets:
        return None
    explicit = any(k in config for k in
                   ("ckpt_dir", "attn", "kv_dtype", "tp", "prefill_chunk",
                    "mesh"))
    if explicit or len(fleets) > 1:
        hit = fleets.get(_fleet_key(config))
        return hit[1] if hit else None
    return next(iter(fleets.values()))[1]


def _handle_fleet(header: dict) -> bytes:
    """``fleet`` request: the fleet's replica table as JSON — per
    replica: health state (HEALTHY/SUSPECT/QUARANTINED/REBUILDING),
    drain flag, rebuild generation, restart count, parked requests,
    and live load (pending/active/done/tokens).  Empty table when no
    fleet is warm yet."""
    config = header.get("config") or {}
    fleet = _resolve_fleet(config)
    if fleet is None:
        return json.dumps({"replicas": 0, "replica": []}).encode("utf-8")
    return json.dumps(_FLEET_SERVICE.fleet_status(fleet)).encode("utf-8")


def _handle_drain(header: dict, undrain: bool = False) -> bytes:
    """``drain`` / ``undrain`` requests: operator drain of one replica
    (config ``{"replica": i}`` plus the engine-selection keys when
    several fleets are warm).  Drain stops placement, lets the replica
    quiesce, then rebuilds it from the recipe; undrain returns it to
    placement.  Responds with the replica's status row; composing
    drain -> poll ``fleet`` until the generation advances -> undrain
    over each replica is a zero-shed rolling restart."""
    config = header.get("config") or {}
    fleet = _resolve_fleet(config)
    if fleet is None:
        raise ValueError("no warm fleet to drain (serve a generate "
                         "request first)")
    idx = int(config.get("replica", 0))
    if not 0 <= idx < len(fleet.replicas):
        raise ValueError(
            f"replica must be in [0, {len(fleet.replicas) - 1}], "
            f"got {idx}")
    if undrain:
        row = _FLEET_SERVICE.undrain(fleet, idx)
    else:
        row = _FLEET_SERVICE.drain(fleet, idx)
    return json.dumps(row).encode("utf-8")


# Lab runs are SERIALIZED even though connections are threaded: their
# "execution time:" lines feed the harness's stats CSVs, and two timed
# kernels sharing the device would inflate each other's numbers.  (A
# lab overlapping generate decode can still contend — point timing


# Lab runs are serialized even though connections are threaded: their
# "execution time:" lines feed the harness's stats CSVs, and two timed
# kernels sharing the device would inflate each other's numbers.
_LAB_LOCK = threading.Lock()

def handle_request(header: dict, payload: bytes,
                   send_chunk=None) -> bytes:
    lab = header.get("lab")
    if lab == "generate":
        return _handle_generate(header, payload, send_chunk)
    if lab == "resume":
        return _handle_resume(header, send_chunk)
    if lab == "generate_stats":
        return _handle_generate_stats(header)
    if lab == "metrics":
        return _handle_metrics(header)
    if lab == "trace_dump":
        return _handle_trace_dump(header)
    if lab == "compile_stats":
        return _handle_compile_stats(header)
    if lab == "postmortem":
        return _handle_postmortem(header)
    if lab == "slowlog":
        return _handle_slowlog(header)
    if lab == "journey":
        return _handle_journey(header)
    if lab == "history":
        return _handle_history(header)
    if lab == "alerts":
        return _handle_alerts(header)
    if lab == "fleet":
        return _handle_fleet(header)
    if lab == "drain":
        return _handle_drain(header)
    if lab == "undrain":
        return _handle_drain(header, undrain=True)
    from tpulab_torch.runtime.device import resolve_device

    if lab == "platform":
        # which backend this daemon computes on: the torch device type
        return resolve_device(BACKEND).type.encode("utf-8")

    from tpulab_torch.labs import get_workload

    mod = get_workload(lab)
    backend = header.get("backend") or BACKEND
    resolve_device(backend)  # no card and no cpu request: refuse, no fallback
    with _LAB_LOCK:
        out = mod.run(
            payload.decode("utf-8"),
            sweep=bool(header.get("sweep", False)),
            backend=backend,
            **(header.get("config") or {}),
        )
    return out.encode("utf-8")


def serve(socket_path: str, *, max_requests: Optional[int] = None,
          stop_event: Optional[threading.Event] = None,
          served_counter: Optional[list] = None) -> None:
    """Accept connections on ``socket_path`` until SIGTERM/SIGINT,
    ``max_requests`` connections, or ``stop_event`` (an embedding
    thread's stop: the accept loop polls it).  ``served_counter``, a
    one-element list, counts the connections handled, for callers that
    check a request really reached the daemon.  The socket appears at
    ``socket_path`` only once it listens (bound under a temporary name,
    then renamed): a client that waits for the path to exist never meets
    a bound socket that refuses it, however long startup's other threads
    (a journal's recoveries) hold the interpreter between the two."""
    pending = socket_path + ".tmp"
    for stale in (socket_path, pending):
        try:
            os.unlink(stale)
        except FileNotFoundError:
            pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(pending)
    srv.listen(16)
    os.rename(pending, socket_path)

    stop = {"flag": False}

    def _sigterm(signum, frame):
        stop["flag"] = True
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _sigterm)
    if stop_event is not None:
        srv.settimeout(0.2)

    # resolve the device before accepting work: no card and no cpu
    # request refuses here, and the first request pays no discovery
    from tpulab_torch.runtime.device import resolve_device

    device = resolve_device(BACKEND)
    # the telemetry-over-time layer: gauge refresh + history sample +
    # alert evaluation + fleet-health application, every
    # METRICS_INTERVAL_S (0 = disabled)
    sampler = start_sampler()
    print(f"[tpulab_torch.daemon] serving on {socket_path} ({device})"
          + (f" (metrics sampler @ {sampler.interval_s:g}s)"
             if sampler is not None else ""), flush=True)

    served = {"n": 0}
    served_lock = threading.Lock()

    conn_sem = threading.Semaphore(MAX_CONN_THREADS)
    budget = _ByteBudget(MAX_TOTAL_PAYLOAD_BYTES)

    def _handle_conn(conn):
        # per-connection thread: long generate requests batch through
        # the shared engine instead of blocking lab traffic (and each
        # other) behind a serial accept loop
        held = 0
        try:
            # a client that connects but never completes the request must
            # not hold its conn_sem slot forever (32 such stalls would
            # wedge accept() for every later client).  The deadline is
            # absolute across the whole request frame — per-op timeouts
            # alone would let a one-byte-per-interval trickle hold the
            # slot indefinitely.  Compute inside handle_request is
            # unaffected; sendall below is bounded per-op by the
            # settimeout state _recv_exact leaves behind.
            deadline = time.monotonic() + RECV_TIMEOUT_S
            raw = _recv_exact(conn, 4, deadline)
            (hlen,) = struct.unpack("<I", raw)
            if hlen > MAX_HEADER_BYTES:
                raise ConnectionError(f"header length {hlen} exceeds cap")
            header = json.loads(_recv_exact(conn, hlen, deadline))
            (plen,) = struct.unpack("<Q", _recv_exact(conn, 8, deadline))
            if plen > MAX_PAYLOAD_BYTES:
                # tell the client why, then DRAIN (bounded by a socket
                # timeout) so its pipelined body send completes and it
                # can actually read the error frame before our close
                err = (f"payload length {plen} exceeds cap "
                       f"{MAX_PAYLOAD_BYTES}").encode()
                conn.settimeout(RECV_TIMEOUT_S)
                conn.sendall(struct.pack("<BQ", 1, len(err)) + err)
                # drain is bounded by wall clock, not just per-op: a
                # trickling sender must not pin the handler here either
                drain_end = time.monotonic() + 5.0
                conn.settimeout(1.0)
                try:
                    while time.monotonic() < drain_end and conn.recv(1 << 16):
                        pass
                except OSError:
                    pass
                raise ConnectionError("oversized payload")
            budget.acquire(plen)
            held = plen
            # the budget wait above can be long (legitimate queueing
            # behind other staged payloads) — the payload frame gets its
            # own fresh deadline so a responsive client isn't evicted
            # for time it spent waiting on US
            payload = _recv_exact(conn, plen,
                                  time.monotonic() + RECV_TIMEOUT_S)
            # compute first, send the TERMINAL frame once: if a sendall
            # fails (send timeout against a non-draining client is
            # possible now that every socket op is bounded), no further
            # frame may follow a partially-written one — the outer
            # except closes the connection instead.  Streaming requests
            # ({"stream": true} on generate) interleave status-2 chunk
            # frames DURING compute; a chunk-send failure aborts the
            # request the same way (broken stream, no terminal frame).
            def send_chunk(data):
                try:
                    if _faults.ACTIVE:
                        _faults.fire("daemon.send")  # wedged client
                    conn.settimeout(RECV_TIMEOUT_S)
                    conn.sendall(
                        struct.pack("<BQ", 2, len(data)) + bytes(data))
                except OSError as e:
                    # a failed sendall may have written PART of the
                    # chunk frame: no further frame may follow it — a
                    # terminal error frame would be parsed as chunk
                    # body / garbage header.  _StreamBroken bypasses
                    # the error-frame path; the outer except closes
                    # the connection.
                    raise _StreamBroken(str(e)) from e

            try:
                out = handle_request(header, payload, send_chunk)
                frame = struct.pack("<BQ", 0, len(out)) + out
            except _StreamBroken:
                raise
            except ShedError as e:
                # load shedding is a PROTOCOL outcome, not a crash: the
                # error body is the bare parseable line ("shed
                # retry_after_ms=<int> (...)"), no traceback — clients
                # back off and retry (tpulab_torch.loadgen)
                err = str(e).encode("utf-8")
                frame = struct.pack("<BQ", 1, len(err)) + err
            except Exception:
                err = traceback.format_exc().encode("utf-8")
                frame = struct.pack("<BQ", 1, len(err)) + err
            # explicit send bound: _recv_exact leaves whatever
            # remaining-time settimeout its last iteration computed
            # (possibly near zero) on the socket
            if _faults.ACTIVE:
                _faults.fire("daemon.send")  # wedged-client-socket site
            conn.settimeout(RECV_TIMEOUT_S)
            conn.sendall(frame)
        except (ConnectionError, TimeoutError):
            pass
        finally:
            if held:
                budget.release(held)
            conn.close()
            conn_sem.release()
            with served_lock:
                served["n"] += 1
                if served_counter is not None:
                    served_counter[0] = served["n"]

    # hoisted ABOVE the try: the SIGTERM KeyboardInterrupt can land on
    # any bytecode inside it, and the graceful drain below reads this
    accepted = 0
    try:
        while not stop["flag"]:
            if stop_event is not None and stop_event.is_set():
                break
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            # bound handler threads: accept stalls at the cap instead of
            # letting a flood of connections each stage a payload buffer
            conn_sem.acquire()
            threading.Thread(
                target=_handle_conn, args=(conn,), daemon=True
            ).start()
            accepted += 1
            if max_requests is not None and accepted >= max_requests:
                # drain: in-flight handlers must finish (and send their
                # responses) before process exit kills their threads
                for _ in range(600):
                    with served_lock:
                        if served["n"] >= accepted:
                            break
                    time.sleep(0.1)
                break
    except KeyboardInterrupt:
        pass
    finally:
        if stop["flag"]:
            # graceful SIGTERM: drain in-flight handlers (bounded), flush
            # + compact the journal so a restart recovers from a minimal
            # file, and persist a shutdown flight-recorder bundle,
            # symmetric with the crash bundles the supervisor records
            for _ in range(150):
                with served_lock:
                    if served["n"] >= accepted:
                        break
                time.sleep(0.1)
            if _JOURNAL is not None:
                try:
                    _JOURNAL.flush()
                    _JOURNAL.compact()
                except Exception:
                    traceback.print_exc()
            with served_lock:
                n_served = served["n"]
            from tpulab_torch.obs import flightrec

            if flightrec.record_postmortem(
                    "shutdown",
                    extra={"accepted": accepted, "served": n_served,
                           "journal": getattr(_JOURNAL, "path", None)},
            ) is not None:
                _C_POSTMORTEMS.inc()
            print(f"[tpulab_torch.daemon] graceful shutdown: accepted="
                  f"{accepted} served={n_served}", flush=True)
        stop_sampler()
        srv.close()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass
        # the mesh engines' ranks end with the daemon
        from tpulab_torch.parallel import mesh_engine

        mesh_engine.close_pools()


def main(argv=None) -> int:
    global PREFILL_CHUNK, REPLICAS, HEDGE_MS, PREFIX_INDEX, SPILL_BLOCKS, \
        SPILL_DTYPE, BACKEND, METRICS_INTERVAL_S, _JOURNAL, AUTOSCALE_MIN, \
        AUTOSCALE_MAX, POOL_SPEC, MESH_SPEC

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--socket", default=os.environ.get("TPULAB_DAEMON_SOCKET", "/tmp/tpulab.sock"))
    ap.add_argument("--max-requests", type=int, default=None, help="exit after N requests (tests)")
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=BACKEND,
                    help="device the daemon serves on: the card (default) "
                         "or, only when asked, the CPU; no fallback")
    ap.add_argument("--replicas", type=int, default=REPLICAS, metavar="N",
                    help="PagedEngine replicas per warm serving config "
                         "(fleet routing: least-loaded + prefix-affinity "
                         "placement, health checks, migration on replica "
                         "failure, drain/undrain rolling restarts)")
    ap.add_argument("--hedge-ms", type=float, default=HEDGE_MS, metavar="MS",
                    help="hedged-retry budget: a request with no first "
                         "token after MS is duplicated on a second "
                         "replica, first token wins (0 = off; "
                         "per-request 'hedge_ms' config overrides)")
    ap.add_argument("--prefill-chunk", type=int, default=PREFILL_CHUNK,
                    help="default prefill window for the serving engines "
                         "(chunked+interleaved admission; 0 = whole-prompt "
                         "dense prefill)")
    ap.add_argument("--metrics-interval", type=float,
                    default=METRICS_INTERVAL_S, metavar="S",
                    help="history sampler cadence in seconds (default "
                         "1.0; 0 disables): every tick appends one "
                         "registry snapshot to the history ring "
                         "('history' request — windowed rates and "
                         "percentiles), evaluates the alert rule "
                         "catalog ('alerts' request), and wires "
                         "replica-degradation alerts into fleet "
                         "placement")
    ap.add_argument("--trace-buffer", type=int, default=None, metavar="N",
                    help="ring-buffer tracer capacity in events (default "
                         "32768; 0 disables tracing); dump it with a "
                         "'trace_dump' request")
    ap.add_argument("--journal", default=os.environ.get("TPULAB_DAEMON_JOURNAL"),
                    metavar="PATH",
                    help="write-ahead request journal (crash "
                         "durability): accepts fsynced before "
                         "admission, committed prefixes checkpointed, "
                         "incomplete requests replayed on restart and "
                         "client streams resumable by rid (default "
                         "TPULAB_DAEMON_JOURNAL env; unset = off, "
                         "streams bit-identical either way)")
    ap.add_argument("--autoscale-min", type=int, default=AUTOSCALE_MIN,
                    metavar="N",
                    help="elastic-fleet floor: the autoscaler never "
                         "retires below N serving replicas (default "
                         "TPULAB_DAEMON_AUTOSCALE_MIN or 1; only "
                         "meaningful with --autoscale-max >= 1)")
    ap.add_argument("--autoscale-max", type=int, default=AUTOSCALE_MAX,
                    metavar="N",
                    help="elastic-fleet ceiling: arm the telemetry-"
                         "driven autoscaler + brownout ladder, scaling "
                         "each warm fleet between --autoscale-min and N "
                         "replicas (default TPULAB_DAEMON_AUTOSCALE_MAX "
                         "or 0 = disarmed, fixed --replicas fleet)")
    ap.add_argument("--pool-spec", default=POOL_SPEC, metavar="SPEC",
                    help="disaggregated serving pools: comma-separated "
                         "role=N or role=MIN..MAX with roles "
                         "prefill/decode/unified, e.g. "
                         "'prefill=1..2,decode=1'.  Admissions place "
                         "into the prefill pool; at the prefill/decode "
                         "boundary the KV blocks hand off to a decode "
                         "replica through the digest-keyed host-spill "
                         "format (streams bit-identical to unified "
                         "serving); ranged pools autoscale "
                         "independently (queue-wait burn for prefill, "
                         "ITL burn for decode).  Requires "
                         "--prefix-index radix and --spill-blocks > 0; "
                         "exclusive with --autoscale-max; overrides "
                         "--replicas (default TPULAB_DAEMON_POOL_SPEC "
                         "or '' = unified fleet)")
    ap.add_argument("--prefix-index", choices=("dict", "radix"), default=PREFIX_INDEX,
                    help="prefix-cache structure for the serving engines")
    ap.add_argument("--spill-blocks", type=int, default=SPILL_BLOCKS, metavar="N",
                    help="host-RAM KV spill tier capacity in blocks (0 = "
                         "off); requires --prefix-index radix")
    ap.add_argument("--spill-dtype", choices=("native", "int8", "int4"),
                    default=SPILL_DTYPE,
                    help="host spill-tier payload format")
    ap.add_argument("--mesh", default=MESH_SPEC, metavar="AxB",
                    help="2D serving mesh 'batch x model' for the "
                         "daemon's engines (e.g. '2x4'): KV pools and "
                         "attention heads shard on the model axis, the "
                         "per-slot decode state on the batch axis; "
                         "'1x1' or '' serves single-device (default "
                         "TPULAB_DAEMON_MESH or ''; per-request "
                         "'mesh' config overrides)")
    ap.add_argument("--slowlog", type=int, default=None, metavar="N",
                    help="slow-log window: keep the worst N requests by e2e "
                         "latency (default 64; 0 disables)")
    ap.add_argument("--journeys", type=int, default=None, metavar="N",
                    help="request-journey store: keep the newest N "
                         "requests' phase waterfalls (default 256; 0 "
                         "disables)")
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.hedge_ms < 0:
        ap.error("--hedge-ms must be >= 0")
    if args.prefill_chunk < 0:
        ap.error("--prefill-chunk must be >= 0")
    if args.metrics_interval < 0:
        ap.error("--metrics-interval must be >= 0 (0 disables)")
    if args.autoscale_max < 0:
        ap.error("--autoscale-max must be >= 0 (0 disarms)")
    if args.trace_buffer is not None and args.trace_buffer < 0:
        ap.error("--trace-buffer must be >= 0")
    if args.slowlog is not None and args.slowlog < 0:
        ap.error("--slowlog must be >= 0")
    if args.journeys is not None and args.journeys < 0:
        ap.error("--journeys must be >= 0")
    if args.spill_blocks < 0:
        ap.error("--spill-blocks must be >= 0 (0 disables)")
    if args.spill_blocks and args.prefix_index != "radix":
        ap.error("--spill-blocks > 0 requires --prefix-index radix "
                 "(the spill tier keys host payloads by radix paths)")
    if args.mesh:
        # parsed and canonicalized here: a bad spec exits 2 before any build
        try:
            args.mesh = _canon_mesh(args.mesh)
        except ValueError as e:
            ap.error(f"--mesh: {e}")
    if args.autoscale_max >= 1:
        # elastic-fleet misconfiguration is rejected HERE with a
        # parseable argparse error, before any engine build
        if args.autoscale_min < 1:
            ap.error("--autoscale-min must be >= 1")
        if args.autoscale_min > args.autoscale_max:
            ap.error(
                f"--autoscale-min ({args.autoscale_min}) must be <= "
                f"--autoscale-max ({args.autoscale_max})")
        if not (args.autoscale_min <= args.replicas
                <= args.autoscale_max):
            ap.error(
                f"--replicas ({args.replicas}) must start inside "
                f"[--autoscale-min, --autoscale-max] = "
                f"[{args.autoscale_min}, {args.autoscale_max}]")
        if args.metrics_interval == 0:
            ap.error("--autoscale-max requires the sampler: "
                     "--metrics-interval must be > 0")
    if args.pool_spec:
        # disaggregated-fleet misconfiguration rejected HERE with a
        # parseable argparse error, same discipline as the elastic
        # bounds above
        try:
            pools = _parse_pool_spec(args.pool_spec)
        except ValueError as e:
            ap.error(f"--pool-spec: {e}")
        if args.autoscale_max >= 1:
            ap.error("--pool-spec and --autoscale-max are exclusive "
                     "(each pool carries its own autoscale bounds)")
        if args.prefix_index != "radix" or not args.spill_blocks:
            ap.error("--pool-spec requires --prefix-index radix and "
                     "--spill-blocks > 0 (the prefill→decode KV "
                     "handoff rides the digest-keyed host-spill "
                     "format)")
        if (any(mx > mn for _, mn, mx in pools)
                and args.metrics_interval == 0):
            ap.error("--pool-spec with ranged pools requires the "
                     "sampler: --metrics-interval must be > 0")
        args.replicas = sum(mn for _, mn, _ in pools)
    BACKEND = args.backend
    PREFILL_CHUNK = args.prefill_chunk
    REPLICAS = args.replicas
    HEDGE_MS = args.hedge_ms
    PREFIX_INDEX = args.prefix_index
    SPILL_BLOCKS = args.spill_blocks
    SPILL_DTYPE = args.spill_dtype
    POOL_SPEC = args.pool_spec
    MESH_SPEC = args.mesh
    METRICS_INTERVAL_S = args.metrics_interval
    AUTOSCALE_MIN = args.autoscale_min
    AUTOSCALE_MAX = args.autoscale_max
    if args.trace_buffer is not None:
        _obs.configure_tracer(args.trace_buffer)
    if args.slowlog is not None:
        _obs.configure_slowlog(args.slowlog)
    if args.journeys is not None:
        _obs.configure_journey(args.journeys)
    if _faults.configure_from_env():
        # chaos runs against a real daemon: arm the injector from
        # TPULAB_FAULTS (JSON schedule); absent means inert
        print("[tpulab_torch.daemon] fault injector ARMED from TPULAB_FAULTS",
              flush=True)
    if args.journal:
        from tpulab_torch.durability import Journal

        _JOURNAL = Journal(args.journal,
                           on_record=_C_JOURNAL_RECORDS.inc)
        n = _recover_from_journal(_JOURNAL)
        print(f"[tpulab_torch.daemon] journal {args.journal}: "
              f"{n} incomplete request(s) recovering", flush=True)
    serve(args.socket, max_requests=args.max_requests)
    return 0


if __name__ == "__main__":
    sys.exit(main())
