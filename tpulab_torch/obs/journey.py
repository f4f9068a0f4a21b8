"""Request journeys: one causal record per request, across engines.

Round 21.  The disaggregated fleet (round 20) split a request's
lifecycle across TWO engines — prefill pool, KV handoff, decode pool —
but every observability surface stayed per-engine: the tracer ring
orders events per process, the slowlog entry is written by whichever
engine *retired* the request, and a histogram bucket says nothing
about which request landed in it.  A tail ITL breach therefore could
not be attributed to queue vs prefill vs handoff transfer vs decode.

This module is the stitching tier.  Engines and the daemon append
tiny *marks* — ``(t, name, replica, pool, nbytes)`` keyed by the
process-unique rid (:func:`tpulab_torch.obs.tracer.next_rid`) — at the
request's phase boundaries, and the store stitches them at READ time
into one journey record with a contiguous phase waterfall:

    queue_wait -> prefill_chunks -> handoff_export -> handoff_transfer
        -> handoff_import -> decode_queue -> decode

(unified fleets collapse to ``queue_wait -> prefill_chunks ->
decode``).  Adjacent phases share their boundary timestamp — one mark
ends a phase and starts the next — so contiguity and monotonicity
hold by construction, which is what lets ``goodput_gate.py
--attribute`` assert them per request instead of hoping.

Hot-path discipline (same contract as the tracer and slowlog):

* ``mark`` is O(1) per *lifecycle edge* — a request crosses fewer
  than a dozen edges over its whole life; nothing here runs per
  token.  One small tuple and one lock acquisition per mark.
* Stitching, sorting, and rendering happen only when somebody asks
  (``snapshot``/``recent`` — the daemon's ``journey`` handler, the
  flight recorder, the gate).
* ``capacity == 0`` disables recording entirely — ``mark`` returns
  before taking the lock, so an ``obs=False`` engine bound to
  :data:`NULL` pays one attribute load and one compare.
* Reads return fresh dicts (copy-on-read); callers may mutate them.

The store is bounded: at most ``capacity`` rids are resident, oldest
evicted first (FIFO by first mark — a journey evicted mid-flight
simply reports fewer phases if later asked for).  On the ``retire``
mark the store emits a ``journey.complete`` trace event so the tracer
ring cross-links back to the stitched record.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from tpulab_torch.obs import tracer as _tracer

#: default resident-journey bound — sized like the slowlog: enough to
#: cover every in-flight request of a saturated CPU fleet plus a tail
#: of recently retired ones for post-hoc queries
DEFAULT_CAPACITY = 256

#: the ordered phase vocabulary of a disaggregated journey (unified
#: journeys use the first two plus ``decode``); render + gate share it
PHASES = ("queue_wait", "prefill_chunks", "handoff_export",
          "handoff_transfer", "handoff_import", "decode_queue", "decode")

#: handoff phases — the slice of :data:`PHASES` whose durations must
#: sum to the request's recorded ``handoff_ms`` (slowlog field) and
#: whose bytes are the handoff payload
HANDOFF_PHASES = ("handoff_export", "handoff_transfer", "handoff_import")


def _ms(dt_s: float) -> float:
    return round(dt_s * 1e3, 3)


class JourneyStore:
    """Bounded per-rid mark store + read-time waterfall stitcher."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self._lock = threading.Lock()
        self._cap = int(capacity)
        # rid -> {"tag": str, "completed": bool, "marks": [(t, name,
        #         replica, pool, nbytes), ...]}  (insertion-ordered for
        # FIFO eviction; marks append in call order, stitch re-sorts)
        self._recs: "OrderedDict[int, dict]" = OrderedDict()
        #: lifetime completed-journey count (survives eviction)
        self.completed = 0
        #: journeys evicted before their retire mark arrived
        self.evicted_inflight = 0

    @property
    def capacity(self) -> int:
        return self._cap

    def resize(self, capacity: int) -> None:
        """Rebound the store in place (the global :data:`JOURNEY` is
        bound once by engines — same discipline as the tracer)."""
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        with self._lock:
            self._cap = int(capacity)
            while len(self._recs) > self._cap:
                _, rec = self._recs.popitem(last=False)
                if not rec["completed"]:
                    self.evicted_inflight += 1

    def clear(self) -> None:
        with self._lock:
            self._recs.clear()
            self.completed = 0
            self.evicted_inflight = 0

    def mark(self, rid: int, name: str, *, t: Optional[float] = None,
             replica: Optional[int] = None, pool: Optional[str] = None,
             nbytes: int = 0, tag: Optional[str] = None) -> None:
        """Record one lifecycle edge for ``rid``.

        ``t`` is a ``time.monotonic()`` stamp; pass the SAME stamp the
        caller already took for its own bookkeeping (e.g. the engine's
        ``req.t_admit``) so the journey boundary and the histogram
        observation agree to the nanosecond.  ``nbytes`` carries the
        handoff payload size on ``handoff_import``."""
        if self._cap == 0:
            return
        if t is None:
            t = time.monotonic()
        done = False
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                while len(self._recs) >= self._cap:
                    _, old = self._recs.popitem(last=False)
                    if not old["completed"]:
                        self.evicted_inflight += 1
                rec = {"tag": "", "completed": False, "marks": []}
                self._recs[rid] = rec
            if tag:
                rec["tag"] = tag
            rec["marks"].append((t, name, replica, pool, int(nbytes)))
            if name == "retire":
                rec["completed"] = True
                self.completed += 1
                done = True
        if done:
            # outside the store lock: the tracer ring gets the
            # cross-link event (never raises, lock-free record path)
            _tracer.event("journey.complete", rid)

    # ----- read side -------------------------------------------------

    def snapshot(self, rid: int) -> Optional[dict]:
        """Stitched journey for ``rid``, or None if unknown/evicted."""
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return None
            marks = list(rec["marks"])
            tag = rec["tag"]
            completed = rec["completed"]
        return _stitch(rid, tag, completed, marks)

    def find_tag(self, tag: str) -> Optional[dict]:
        """Stitched journey for the NEWEST rid carrying ``tag`` (the
        wire tag is the loadgen journal key — the gate's join column;
        retries reuse it, newest wins)."""
        with self._lock:
            hit = None
            for rid, rec in self._recs.items():
                if rec["tag"] == tag:
                    hit = (rid, rec["tag"], rec["completed"],
                           list(rec["marks"]))
        if hit is None:
            return None
        return _stitch(*hit)

    def recent(self, n: int = 8, completed_only: bool = False) -> List[dict]:
        """The ``n`` newest journeys (by first mark), newest first."""
        with self._lock:
            items = [(rid, rec["tag"], rec["completed"], list(rec["marks"]))
                     for rid, rec in self._recs.items()
                     if rec["completed"] or not completed_only]
        return [_stitch(*it) for it in reversed(items[-max(0, int(n)):])]

    def stats(self) -> dict:
        with self._lock:
            return {"capacity": self._cap, "resident": len(self._recs),
                    "completed": self.completed,
                    "evicted_inflight": self.evicted_inflight}


def _first(marks, name, after: float = -1.0):
    """First mark called ``name`` at or after ``after`` (marks sorted)."""
    for m in marks:
        if m[1] == name and m[0] >= after:
            return m
    return None


def _stitch(rid: int, tag: str, completed: bool, marks: list) -> dict:
    """Fold raw marks into the phase waterfall.

    Tolerant by design: a journey whose engine ran ``obs=False`` for
    part of its life (or that was resubmitted through a replay path)
    yields the phases its marks support and no more — the gate asserts
    completeness only on traces it controlled end-to-end."""
    marks = sorted(marks, key=lambda m: m[0])
    sub = _first(marks, "submit")
    out: Dict[str, Any] = {
        "rid": rid, "tag": tag, "completed": completed,
        "phases": [], "e2e_ms": None, "handoff_ms": None,
        "handoff_bytes": 0, "replicas": [], "pools": [],
        "marks": len(marks),
        "migrations": sum(1 for m in marks if m[1] == "migrate"),
        "replays": sum(1 for m in marks if m[1] == "replay"),
    }
    if sub is None:
        return out
    t0 = sub[0]
    phases: List[dict] = []

    def phase(name, a, b, *, nbytes=0):
        # boundary marks are shared: phase N ends at the exact stamp
        # phase N+1 starts from — contiguity by construction
        replica = b[2] if b[2] is not None else a[2]
        pool = b[3] if b[3] is not None else a[3]
        phases.append({
            "phase": name,
            "t0_ms": _ms(a[0] - t0), "t1_ms": _ms(b[0] - t0),
            "ms": _ms(b[0] - a[0]),
            "replica": replica, "pool": pool, "bytes": int(nbytes),
        })

    admit = _first(marks, "admit", sub[0])
    if admit is not None:
        phase("queue_wait", sub, admit)
        ready = _first(marks, "handoff_ready", admit[0])
        exp = _first(marks, "handoff_export", ready[0]) if ready else None
        imp_b = _first(marks, "handoff_import_begin",
                       exp[0]) if exp else None
        imp = _first(marks, "handoff_import", imp_b[0]) if imp_b else None
        retire = _first(marks, "retire", admit[0])
        if imp is not None:
            # full disaggregated chain: the payload size is measured
            # once, at import (the same number the daemon's
            # handoff_bytes counter ingests) and attributed to every
            # handoff phase — it is one payload crossing one edge
            nb = imp[4]
            out["handoff_bytes"] = nb
            phase("prefill_chunks", admit, ready)
            phase("handoff_export", ready, exp, nbytes=nb)
            phase("handoff_transfer", exp, imp_b, nbytes=nb)
            phase("handoff_import", imp_b, imp, nbytes=nb)
            out["handoff_ms"] = _ms(imp[0] - ready[0])
            admit2 = _first(marks, "admit", imp[0])
            if admit2 is not None:
                phase("decode_queue", imp, admit2)
                retire = _first(marks, "retire", admit2[0])
                if retire is not None:
                    phase("decode", admit2, retire)
        else:
            pfd = _first(marks, "prefill_done", admit[0]) or ready
            if pfd is not None:
                phase("prefill_chunks", admit, pfd)
                if retire is not None and retire[0] >= pfd[0]:
                    phase("decode", pfd, retire)
        if retire is not None:
            out["e2e_ms"] = _ms(retire[0] - t0)
    out["phases"] = phases
    seen_r, seen_p = [], []
    for m in marks:
        if m[2] is not None and m[2] not in seen_r:
            seen_r.append(m[2])
        if m[3] is not None and m[3] not in seen_p:
            seen_p.append(m[3])
    out["replicas"], out["pools"] = seen_r, seen_p
    return out


#: process-global store — the daemon's ``journey`` handler, the flight
#: recorder, and every obs=True engine share it (rids are
#: process-unique, so cross-engine marks interleave safely)
JOURNEY = JourneyStore()

#: disabled twin for obs=False engines (mark() is a two-op no-op)
NULL = JourneyStore(0)


def configure_journey(capacity: int) -> None:
    """Resize the global store in place (0 disables).  Mirrors
    :func:`tpulab_torch.obs.tracer.configure_tracer` — engines bind the
    global once at construction, so resizing must mutate it."""
    JOURNEY.resize(capacity)
