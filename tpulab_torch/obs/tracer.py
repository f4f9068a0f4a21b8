"""Zero-sync ring-buffer event tracer with Chrome-trace / Perfetto export.

The paged engine's counters say *that* a sync barrier or stall happened;
they cannot say *when*, or what the host was doing around it.  ``torch.profiler``
(``tpulab_torch.obs.profiler.maybe_trace``) answers that for device
ops but costs enough to be a dedicated profiling run.  This tracer is
the always-on middle ground: host-side timeline events cheap enough to
leave enabled in production serving.

Hot-path contract — the reason this file exists instead of a logging
call:

* recording an event is ONE tuple append into a **preallocated** ring
  buffer: ``(t_monotonic_ns, kind, name_id, thread_id, arg)``.  Never a
  device sync, never a string format, never a dict allocation — names
  are interned to integer ids once (first use, under a lock that the
  steady state never takes again), timestamps come from
  ``time.monotonic_ns()`` (a vDSO read), and formatting is deferred
  entirely to export time.
* the buffer wraps: a long-running daemon keeps the most recent
  ``capacity`` events and the export reports how many were dropped —
  recording never blocks, never grows, never ages out by wall time.
* multiple threads record without coordination (the slot index comes
  from an ``itertools.count``, atomic under the GIL); a wrap-adjacent
  collision can at worst overwrite one slot, never corrupt the stream.

Export is the Chrome trace-event JSON format (``{"traceEvents": [...]}``
with ``B``/``E`` duration pairs and ``i`` instants), which
https://ui.perfetto.dev loads directly — the daemon's ``trace_dump``
request returns exactly this JSON.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Optional

_BEGIN, _END, _INSTANT = 0, 1, 2
_PH = ("B", "E", "i")

#: default ring capacity: ~32k events (a few MB of tuples) — hours of
#: steady-state serving at the engine's per-boundary event rate
DEFAULT_CAPACITY = 1 << 15


class _Span:
    """Reusable span handle for ONE (tracer, name) pair.

    Carries no per-entry state — enter/exit only append B/E records, so
    a single cached instance is safe to reuse concurrently and
    re-entrantly (nesting reconstructs from B/E pairing per thread, the
    Chrome trace rule).  ``span(name)`` in the steady state is therefore
    one dict lookup, zero allocation.
    """

    __slots__ = ("_tr", "_nid")

    def __init__(self, tr: "Tracer", nid: int):
        self._tr = tr
        self._nid = nid

    def __enter__(self):
        self._tr._record(_BEGIN, self._nid, None)
        return self

    def __exit__(self, *exc):
        self._tr._record(_END, self._nid, None)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Preallocated ring buffer of timeline events; capacity 0 disables
    (every record path returns immediately)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()  # intern/resize/export only
        self.resize(capacity)

    def resize(self, capacity: int) -> None:
        """(Re)allocate the ring; drops recorded events and interned
        names.  Not a hot-path operation — daemon startup
        (``--trace-buffer``), benches, and tests."""
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        with self._lock:
            self.capacity = int(capacity)
            self._buf = [None] * self.capacity
            self._seq = itertools.count()
            self._names = {}      # name -> id
            self._ids = []        # id -> name
            self._spans = {}      # name -> cached _Span
            self.enabled = self.capacity > 0

    def clear(self) -> None:
        self.resize(self.capacity)

    # ------------------------------------------------------------ record
    def _intern(self, name: str) -> int:
        with self._lock:
            nid = self._names.get(name)
            if nid is None:
                nid = self._names[name] = len(self._ids)
                self._ids.append(name)
                self._spans[name] = _Span(self, nid)
            return nid

    def _record(self, kind: int, nid: int, arg) -> None:
        # snapshot buf/capacity into locals: a concurrent resize()/
        # clear() (configure_tracer at daemon startup, bench A/B
        # windows) swaps both attributes, and reading them twice could
        # divide by a fresh capacity of 0 or index the wrong buffer —
        # with the locals the record lands harmlessly in the OLD ring
        buf = self._buf
        cap = len(buf)
        if cap:
            buf[next(self._seq) % cap] = (
                time.monotonic_ns(), kind, nid, threading.get_ident(), arg)

    def span(self, name: str):
        """Context manager bracketing a named region (B/E pair)."""
        if not self.enabled:
            return _NOOP_SPAN
        sp = self._spans.get(name)
        if sp is None:
            self._intern(name)
            sp = self._spans[name]
        return sp

    def begin(self, name: str, arg=None) -> None:
        """Open a named span carrying ``arg`` on its B record (the
        cached :meth:`span` handles are argless by design — they are
        shared across requests).  Zero-allocation like ``event``; pair
        with :meth:`end` in a try/finally.  Used for the per-request
        span tree: a ``begin("engine.prefill_chunk", rid)`` links the
        chunk's duration to the request's other rid-carrying events."""
        if not self.enabled:
            return
        nid = self._names.get(name)
        if nid is None:
            nid = self._intern(name)
        self._record(_BEGIN, nid, arg)

    def end(self, name: str) -> None:
        """Close the span :meth:`begin` opened (E records carry no
        arg; Chrome-trace pairs B/E per thread by nesting order)."""
        if not self.enabled:
            return
        nid = self._names.get(name)
        if nid is None:
            nid = self._intern(name)
        self._record(_END, nid, None)

    def event(self, name: str, arg=None, **args) -> None:
        """Instant event.  ``arg`` carries one scalar at tuple-append
        cost; keyword ``args`` are allowed for RARE rich events (they
        allocate the kwargs dict — keep them off per-tick paths)."""
        if not self.enabled:
            return
        nid = self._names.get(name)
        if nid is None:
            nid = self._intern(name)
        self._record(_INSTANT, nid, args or arg)

    # ------------------------------------------------------------ export
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (loads in Perfetto as-is).

        Events are emitted in (timestamp, kind) order — chronological,
        with a B sorting before the E/instant sharing its nanosecond —
        regardless of where the ring's write cursor wrapped.  ``ts`` is
        microseconds relative to the oldest retained event (the Chrome
        format's unit).  ``otherData`` reports recorded vs dropped so a
        consumer knows when the window wrapped."""
        with self._lock:
            entries = [e for e in self._buf if e is not None]
            ids = list(self._ids)
            recorded = next(self._seq)  # consumes one: restore below
            self._seq = itertools.count(recorded)
        # a racing recorder from before a resize can leave an entry
        # whose name id predates the cleared intern table — drop it
        # rather than IndexError the whole export
        entries = [e for e in entries if e[2] < len(ids)]
        entries.sort(key=lambda e: (e[0], e[1]))
        t0 = entries[0][0] if entries else 0
        events = []
        pid = os.getpid()
        for t, kind, nid, tid, arg in entries:
            ev = {"name": ids[nid], "ph": _PH[kind],
                  "ts": (t - t0) / 1e3, "pid": pid, "tid": tid}
            if kind == _INSTANT:
                ev["s"] = "t"  # thread-scoped instant
            if arg is not None:
                ev["args"] = arg if isinstance(arg, dict) else {"arg": arg}
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorded": recorded,
                "dropped": max(0, recorded - self.capacity),
            },
        }

    def rid_events(self, rid: int) -> list:
        """Every retained event whose arg links it to ``rid`` — the
        raw material the journey tier (round 21) stitches and the
        flight recorder embeds next to a dying request's journey.
        Matches both scalar-arg events (``event(name, rid)`` — the
        per-request convention) and rich events carrying
        ``{"rid": rid, ...}``.  Chronological ``(t_ns, name, arg)``
        tuples; copy-on-read like :meth:`chrome_trace`."""
        with self._lock:
            entries = [e for e in self._buf if e is not None]
            ids = list(self._ids)
        out = []
        for t, kind, nid, tid, arg in entries:
            if nid >= len(ids):
                continue
            if arg == rid or (isinstance(arg, dict)
                              and arg.get("rid") == rid):
                out.append((t, ids[nid], arg))
        out.sort(key=lambda e: e[0])
        return out


#: the process-global tracer the engine/daemon/trainer record into; a
#: disabled twin (NULL) lets callers branch once at construction time
#: instead of per event
TRACER = Tracer()
NULL = Tracer(0)

#: process-global request-id allocator: every request the daemon or an
#: engine admits gets ONE ``rid``, unique across all engines in the
#: process (engine-local ``req_id`` restarts at 0 per engine and per
#: supervisor rebuild — it cannot key a process-wide trace).  The rid
#: is the LINK between a request's tracer events (engine.submit /
#: admit / first_token / token / retire / preempt, daemon.shed /
#: daemon.replay — all carry it as their arg) and its slow-log span
#: summary (tpulab_torch.obs.slowlog).  ``next()`` on itertools.count is
#: atomic under the GIL — no lock on the submit path.
_RID = itertools.count(1)


def next_rid() -> int:
    """Allocate the next process-unique request id."""
    return next(_RID)


def configure_tracer(capacity: Optional[int]) -> Tracer:
    """Set the global tracer's ring capacity (0 disables); returns it.
    The daemon's ``--trace-buffer N`` lands here."""
    if capacity is not None:
        TRACER.resize(capacity)
    return TRACER


def span(name: str):
    return TRACER.span(name)


def event(name: str, arg=None, **args) -> None:
    TRACER.event(name, arg, **args)
