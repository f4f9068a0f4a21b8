"""Per-request slow log: bounded worst-N request span summaries.

A latency histogram can say *that* the p99 blew its budget; it cannot
name the request that did it.  This module keeps the worst-N RETIRED
requests by end-to-end latency, each with the compact span summary the
engine recorded at its host-side boundaries — queue wait, prefill
chunk count and span, TTFT, the worst inter-token gap AND which token
it landed on, preemption/resubmit counts — so "p99 blew the budget"
converts directly into "this request, this tick".

Every entry carries the process-unique ``rid``
(:func:`tpulab_torch.obs.tracer.next_rid`): the same id every tracer event
for that request carries as its arg, so a slow-log entry links
straight to the request's span tree in a Perfetto dump.  ``tag`` is
the caller-supplied label (the daemon passes the wire config's
``tag`` through), which lets a load generator map a slow-log entry
back to its trace row.

Hot-path contract: :meth:`SlowLog.record` runs once per retired
request (never per tick or token) — one heap push/replace under a
lock, O(log capacity), no string formatting.  The daemon's ``slowlog``
request renders :meth:`SlowLog.worst` as JSON.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, List, Mapping, Optional

#: default worst-N window: enough to cover every slow request of a
#: capture run without growing with traffic
DEFAULT_CAPACITY = 64


class SlowLog:
    """Thread-safe bounded worst-N log keyed by the entry's ``e2e_ms``.

    Internally a min-heap of (e2e_ms, seq, entry): the CHEAPEST of the
    retained worst-N sits at the root, so a faster-than-root request is
    rejected in O(1) and a slower one replaces it in O(log capacity).
    ``seq`` breaks e2e ties FIFO so dict entries never get compared.
    Capacity 0 disables recording entirely."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self.resize(capacity)

    def resize(self, capacity: int) -> None:
        """(Re)size the window; drops retained entries.  Startup/tests
        only — the daemon's ``--slowlog N`` lands here."""
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        with self._lock:
            self.capacity = int(capacity)
            self._heap: list = []
            self._seq = itertools.count()
            self._recorded = 0

    def clear(self) -> None:
        self.resize(self.capacity)

    def record(self, entry: Mapping) -> None:
        """Retain ``entry`` if it is among the worst-N seen so far.
        ``entry`` must carry a numeric ``e2e_ms``; it is copied, so the
        caller may reuse its dict."""
        if not self.capacity:
            return
        e2e = float(entry["e2e_ms"])
        with self._lock:
            self._recorded += 1
            if len(self._heap) < self.capacity:
                heapq.heappush(self._heap, (e2e, next(self._seq),
                                            dict(entry)))
            elif e2e > self._heap[0][0]:
                heapq.heapreplace(self._heap, (e2e, next(self._seq),
                                               dict(entry)))

    @property
    def recorded(self) -> int:
        """Requests ever offered to this log (retained or not)."""
        return self._recorded

    def worst(self, n: Optional[int] = None, *,
              clear: bool = False) -> List[Dict]:
        """The retained entries, WORST (largest e2e_ms) first; at most
        ``n`` of them — see :meth:`snapshot` for the full atomic view
        (entries + recorded count from one lock acquisition)."""
        return self.snapshot(n, clear=clear)["worst"]

    def snapshot(self, n: Optional[int] = None, *,
                 clear: bool = False) -> Dict:
        """Atomic copy-on-read view: ``{"worst", "recorded",
        "capacity"}`` all from the SAME lock acquisition, so the
        response can never claim "worst 5 of 4 recorded".  ``clear=
        True`` additionally resets the log inside that acquisition — a
        per-window capture (the daemon's ``slowlog {"clear": true}``)
        must never drop an entry recorded between a separate read and
        clear: every entry lands in exactly one window."""
        with self._lock:
            items = sorted(self._heap, key=lambda t: (-t[0], t[1]))
            recorded = self._recorded
            if clear:
                self._heap = []
                self._recorded = 0
        if n is not None:
            items = items[: max(0, int(n))]
        return {"worst": [dict(e) for _, _, e in items],
                "recorded": recorded, "capacity": self.capacity}

    def find(self, rid: int) -> Optional[Dict]:
        """The retained entry for ``rid``, or None.  Round 21: the
        journey tier and its consistency tests join a slow-log span
        summary to the stitched journey sharing the rid — this is the
        lookup half of that join (O(capacity) scan; read path only)."""
        with self._lock:
            for _, _, e in self._heap:
                if e.get("rid") == rid:
                    return dict(e)
        return None


#: the process-global slow log the engines record into and the daemon's
#: ``slowlog`` request renders
SLOWLOG = SlowLog()


def configure_slowlog(capacity: Optional[int]) -> SlowLog:
    """Set the global slow log's window (0 disables); returns it.  The
    daemon's ``--slowlog N`` lands here."""
    if capacity is not None:
        SLOWLOG.resize(capacity)
    return SLOWLOG
