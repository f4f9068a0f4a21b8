"""Metrics history: a fixed-capacity ring of registry snapshots and the
windowed delta/rate math on top of it.

The port's copy of ``tpulab.obs.history`` (the same math on the port's
registry).  Every other surface of the obs layer — the Prometheus
scrape, the goodput gate, the fleet router — reads the registry's
CUMULATIVE state: counters since process start, histograms since the
first request.  Production serving is operated on *rates over windows*
(tokens/s over the last 30 s, TTFT p99 over the last 5 min, error-budget
burn over two windows at once), and the shed check without a sampler has
to hand-roll a two-mark rolling snapshot just to make one p99 decay.
This module makes the time dimension a first-class primitive:

* :class:`MetricsHistory` — a preallocated ring of
  ``(t_monotonic, Registry.snapshot())`` samples, appended by a periodic
  sampler (the daemon's ``--metrics-interval``, default ~1 s).  Sampling
  is the only allocation; every windowed computation between two
  retained samples reuses caller-provided scratch (``counts_delta(...,
  out=)``) so an alert engine evaluating dozens of rules per tick does
  not churn the heap.
* **Windowed histogram differencing** — :func:`counts_delta` subtracts
  two cumulative bucket-count vectors with the Prometheus counter-reset
  rule (any negative per-bucket delta, or a shrunk total, means the
  metric restarted — an engine eviction zeroes the ``engine_*`` mirror,
  a test clears a registry — and the NEW counts ARE the delta), so
  ``percentile_from_buckets`` works over "the last 30 s" instead of
  process lifetime.
* :class:`Window` — the delta view between two samples: counter
  rates, histogram window percentiles/counts/means, gauge endpoints,
  and :func:`fraction_le` (the share of windowed observations at or
  under a budget — the error-rate input to SLO burn math,
  :mod:`tpulab_torch.obs.alerts`).
* :class:`Sampler` — the background thread that drives it (daemon-owned;
  benches and tests drive :meth:`MetricsHistory.sample` directly for
  determinism).

The ring holds ``capacity`` samples (default 900 — 15 min at the 1 s
default cadence); ``window(seconds)`` resolves "the sample at or before
now-seconds" by binary search over the retained span.  Nothing here
touches a device or an engine: history READS the registry the hot paths
already write, so the obs-on/off bit-equality and zero-transfer
contracts are structurally unaffected (held against ``tpulab``'s copy in
tests/test_torch_obs_history.py; the ``obs_history_overhead`` bench row
holds sampler+alerts inside the 3% obs budget).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tpulab_torch.obs.registry import REGISTRY, Registry, percentile_from_buckets

#: default ring capacity: 15 minutes at the daemon's 1 s default cadence
DEFAULT_CAPACITY = 900

#: default sampler cadence in seconds (the daemon's --metrics-interval)
DEFAULT_INTERVAL_S = 1.0


def counts_delta(new: Sequence[int], old: Optional[Sequence[int]],
                 out: Optional[List[int]] = None) -> List[int]:
    """Per-bucket difference ``new - old`` of two cumulative histogram
    count vectors, with the counter-reset rule: if ANY bucket went
    backwards (a restarted metric — registry cleared, engine evicted and
    its gauge mirror re-zeroed, a private test registry), the new counts
    themselves are the delta, exactly Prometheus's ``increase()``
    semantics.  ``old=None`` (metric absent from the older sample — it
    was created inside the window) is a reset by definition.

    ``out`` is reused when given and correctly sized — the alert
    engine's per-rule scratch, so a rule evaluation allocates nothing
    after its first tick."""
    n = len(new)
    if out is None or len(out) != n:
        out = [0] * n
    if old is None or len(old) != n:
        out[:] = new
        return out
    for i in range(n):
        d = new[i] - old[i]
        if d < 0:  # reset inside the window: new counts ARE the delta
            out[:] = new
            return out
        out[i] = d
    return out


def value_delta(new: float, old: Optional[float]) -> float:
    """Counter delta with the same reset rule as :func:`counts_delta`:
    a counter that went backwards restarted, and its new value is the
    best available estimate of the windowed increase."""
    if old is None or new < old:
        return new
    return new - old


def fraction_le(bounds: Sequence[float], counts: Sequence[int],
                x: float) -> float:
    """Estimated fraction of observations <= ``x`` from per-bucket
    counts (``len(bounds) + 1`` entries, +Inf overflow last), linearly
    interpolated inside the bucket containing ``x`` — the inverse of
    :func:`percentile_from_buckets`, and the error-rate input to SLO
    burn math (violations = 1 - fraction_le(budget)).  Returns 1.0 for
    an empty window (no observations -> no violations)."""
    total = sum(counts)
    if total == 0:
        return 1.0
    cum = 0.0
    lo = 0.0
    for i, b in enumerate(bounds):
        if x < b:
            frac = 0.0 if b <= lo else max(0.0, (x - lo) / (b - lo))
            return min(1.0, (cum + counts[i] * frac) / total)
        cum += counts[i]
        lo = b
    return 1.0  # x at or past the last finite bound: overflow included
    # in nothing <= x would need resolution the buckets don't have —
    # clamp optimistic, symmetric with percentile's overflow clamp


class Window:
    """Delta view between two retained samples (``old`` may be None —
    everything since process start).  All accessors are tolerant of
    absent metrics (return 0/None) so a rule written against an engine
    gauge evaluates cleanly on a daemon that has not built one yet."""

    __slots__ = ("t0", "t1", "old", "new", "duration_s")

    def __init__(self, t0: float, old: Optional[Dict], t1: float,
                 new: Dict):
        self.t0 = t0
        self.t1 = t1
        self.old = old
        self.new = new
        self.duration_s = max(1e-9, t1 - t0)

    def _pair(self, name: str):
        n = self.new.get(name)
        o = self.old.get(name) if self.old else None
        return o, n

    def has(self, name: str) -> bool:
        return name in self.new

    def gauge(self, name: str, default: float = 0.0) -> float:
        """Latest value of a gauge (or counter) — point-in-time, not
        windowed."""
        m = self.new.get(name)
        return float(m["value"]) if m and "value" in m else default

    def delta(self, name: str) -> float:
        """Windowed increase of a counter (or monotone gauge), reset-
        clamped."""
        o, n = self._pair(name)
        if n is None or "value" not in n:
            return 0.0
        return value_delta(float(n["value"]),
                           float(o["value"]) if o and "value" in o
                           else None)

    def rate(self, name: str) -> float:
        """Windowed per-second rate of a counter."""
        return self.delta(name) / self.duration_s

    def hist_delta(self, name: str,
                   out: Optional[List[int]] = None
                   ) -> Optional[Tuple[Tuple[float, ...], List[int]]]:
        """(bounds, per-bucket windowed counts) for a histogram, or
        None when the metric is absent / not a histogram.  ``out`` is
        the caller's reusable scratch (see :func:`counts_delta`)."""
        o, n = self._pair(name)
        if n is None or n.get("type") != "histogram":
            return None
        old_counts = o["counts"] if o and o.get("type") == "histogram" \
            else None
        return n["bounds"], counts_delta(n["counts"], old_counts, out)

    def count(self, name: str) -> int:
        """Observations recorded inside the window."""
        d = self.hist_delta(name)
        return sum(d[1]) if d else 0

    def percentile(self, name: str, q: float,
                   out: Optional[List[int]] = None) -> float:
        """q-quantile of a histogram over THIS window (0.0 when empty —
        same convention as the registry's lifetime percentile)."""
        d = self.hist_delta(name, out)
        if d is None:
            return 0.0
        return percentile_from_buckets(d[0], d[1], q)

    def fraction_le(self, name: str, x: float,
                    out: Optional[List[int]] = None) -> float:
        """Fraction of windowed observations <= ``x`` (1.0 when the
        window is empty — no traffic burns no budget)."""
        d = self.hist_delta(name, out)
        if d is None:
            return 1.0
        return fraction_le(d[0], d[1], x)


class MetricsHistory:
    """Fixed-capacity ring of ``(t_monotonic, registry snapshot)``
    samples.  Thread-safe: the sampler appends under the lock; readers
    copy the retained (t, snapshot) PAIRS under it (the snapshots
    themselves are already copy-on-read — ``Registry.snapshot`` copied
    every metric under its own lock when the sample was taken, and no
    one mutates them after)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self.resize(capacity)

    def resize(self, capacity: int) -> None:
        """(Re)allocate the ring; drops retained samples.  Startup and
        tests only."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._lock:
            self.capacity = int(capacity)
            self._buf: List = [None] * self.capacity
            self._n = 0          # total samples ever appended
            self.interval_s: Optional[float] = None  # sampler cadence

    def clear(self) -> None:
        self.resize(self.capacity)

    # ----------------------------------------------------------- sampling
    def sample(self, registry: Registry = REGISTRY,
               now: Optional[float] = None) -> Tuple[float, Dict]:
        """Append one ``(t, snapshot)`` sample and return it.  The
        daemon's sampler calls this every ``--metrics-interval``; tests
        call it directly with explicit ``now`` values for deterministic
        window math."""
        t = time.monotonic() if now is None else float(now)
        snap = registry.snapshot()
        with self._lock:
            self._buf[self._n % self.capacity] = (t, snap)
            self._n += 1
        return t, snap

    @property
    def samples(self) -> int:
        """Samples currently retained (<= capacity)."""
        return min(self._n, self.capacity)

    @property
    def total_samples(self) -> int:
        """Samples ever appended (ring wraps past capacity)."""
        return self._n

    def _retained_locked(self) -> List[Tuple[float, Dict]]:
        n = min(self._n, self.capacity)
        if n == 0:
            return []
        start = self._n - n
        return [self._buf[(start + i) % self.capacity] for i in range(n)]

    def retained(self) -> List[Tuple[float, Dict]]:
        """The retained samples, oldest first."""
        with self._lock:
            return self._retained_locked()

    def latest(self) -> Optional[Tuple[float, Dict]]:
        with self._lock:
            if self._n == 0:
                return None
            return self._buf[(self._n - 1) % self.capacity]

    def age_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the newest sample (None when empty) — the
        staleness signal the ``sampler_stale`` alert rule watches."""
        last = self.latest()
        if last is None:
            return None
        return (time.monotonic() if now is None else now) - last[0]

    # ------------------------------------------------------------ windows
    def window(self, seconds: float, now: Optional[float] = None,
               end: Optional[Tuple[float, Dict]] = None
               ) -> Optional[Window]:
        """The delta view covering (roughly) the last ``seconds``:
        newest retained sample as the window end (or the caller's live
        ``end`` pair — the shed path hands a fresh registry snapshot so
        the window is exact-to-now), and the newest sample at or before
        ``end - seconds`` as the base.  None when no sample exists yet;
        a window older than the ring's span falls back to the oldest
        retained sample (the view covers what history can prove)."""
        with self._lock:
            retained = self._retained_locked()
        if end is None:
            if not retained:
                return None
            t1, new = retained[-1]
            retained = retained[:-1]
        else:
            t1, new = end
        target = t1 - float(seconds)
        if not retained:
            # only the end itself exists: the since-start view (callers
            # treat duration-free rates as startup noise)
            return Window(t1, None, t1, new)
        times = [t for t, _ in retained]
        i = bisect.bisect_right(times, target) - 1
        if i < 0:
            i = 0  # window predates the ring: oldest sample is the base
        t0, old = retained[i]
        if t0 >= t1:  # single-sample history: nothing to difference yet
            return Window(t1, None, t1, new)
        return Window(t0, old, t1, new)

    def live_window(self, seconds: float,
                    registry: Registry = REGISTRY) -> Optional[Window]:
        """A window ending NOW (fresh snapshot, not appended to the
        ring) over the last ``seconds`` — what the daemon's shed check
        uses so admission decisions see requests recorded since the
        last sampler tick."""
        return self.window(seconds,
                           end=(time.monotonic(), registry.snapshot()))

    # ------------------------------------------------------------- series
    def series(self, name: str, seconds: float, *, rate: bool = False,
               now: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Per-sample time series of a metric over the last ``seconds``
        — ``[(age_s_before_newest, value), ...]`` oldest first.  For
        ``rate=True`` the value is the per-second increase since the
        PREVIOUS sample (reset-clamped; histograms use their total
        count): the ops console's sparkline feed."""
        retained = self.retained()
        if not retained:
            return []
        t1 = retained[-1][0]
        lo = t1 - float(seconds)
        out: List[Tuple[float, float]] = []
        prev: Optional[Tuple[float, Dict]] = None
        for t, snap in retained:
            m = snap.get(name)
            if t < lo:
                prev = (t, snap)
                continue
            if m is None:
                prev = (t, snap)
                continue
            if m.get("type") == "histogram":
                cur = float(m["count"])
            else:
                cur = float(m["value"])
            if rate:
                if prev is None:
                    prev = (t, snap)
                    continue
                pm = prev[1].get(name)
                if pm is None:
                    base = None
                elif pm.get("type") == "histogram":
                    base = float(pm["count"])
                else:
                    base = float(pm["value"])
                dt = max(1e-9, t - prev[0])
                out.append((t - t1, value_delta(cur, base) / dt))
            else:
                out.append((t - t1, cur))
            prev = (t, snap)
        return out

    # ------------------------------------------------------------- report
    def report(self, seconds: float = 30.0,
               series: Sequence[str] = (),
               series_seconds: Optional[float] = None,
               percentiles: Sequence[float] = (0.5, 0.9, 0.99)) -> Dict:
        """The ``history`` daemon request's JSON body: ring state, one
        windowed summary (every counter's rate, every histogram's
        windowed count/percentiles), and optional per-metric rate
        series for sparklines."""
        w = self.window(seconds)
        out: Dict = {
            "capacity": self.capacity,
            "samples": self.samples,
            "total_samples": self.total_samples,
            "interval_s": self.interval_s,
            "age_s": self.age_s(),
        }
        if w is None:
            out["window"] = None
            return out
        rates: Dict[str, float] = {}
        hists: Dict[str, Dict] = {}
        for name, m in w.new.items():
            if m.get("type") == "counter":
                rates[name] = round(w.rate(name), 6)
            elif m.get("type") == "histogram":
                d = w.hist_delta(name)
                cnt = sum(d[1]) if d else 0
                row = {"count": cnt}
                for q in percentiles:
                    row[f"p{int(q * 100)}_ms"] = round(
                        percentile_from_buckets(d[0], d[1], q) * 1e3, 3
                    ) if cnt else 0.0
                hists[name] = row
        out["window"] = {
            "seconds": round(w.duration_s, 3),
            "rates": rates,
            "histograms": hists,
        }
        if series:
            span = float(series_seconds if series_seconds is not None
                         else seconds)
            out["series"] = {
                name: [[round(dt, 3), round(v, 6)]
                       for dt, v in self.series(name, span, rate=True)]
                for name in series
            }
        return out


class Sampler:
    """Background thread appending one history sample per interval and
    running a caller-supplied hook (the daemon's alert evaluation +
    fleet health application) after each.  Exceptions in one tick are
    contained (counted, never kill the thread): a transient hook
    failure must not silently end telemetry."""

    def __init__(self, history: MetricsHistory,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 on_sample: Optional[Callable[[], None]] = None,
                 before_sample: Optional[Callable[[], None]] = None,
                 registry: Registry = REGISTRY):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.history = history
        self.interval_s = float(interval_s)
        self.on_sample = on_sample
        #: runs BEFORE the snapshot is taken — the daemon refreshes the
        #: engine_* gauge mirror here so every sample carries live
        #: engine stats, not whatever the last scrape left behind
        self.before_sample = before_sample
        self.registry = registry
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self) -> None:
        """One sampler iteration (refresh + sample + hook) — the
        deterministic entry tests and the alert engine's unit drivers
        use."""
        self.history.interval_s = self.interval_s
        if self.before_sample is not None:
            self.before_sample()
        self.history.sample(self.registry)
        if self.on_sample is not None:
            self.on_sample()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — telemetry must outlive
                # one bad tick; the error count is itself observable
                self.errors += 1

    def start(self) -> "Sampler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self.history.interval_s = self.interval_s
            self._thread = threading.Thread(
                target=self._run, name="tpulab-metrics-sampler",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()


#: the process-global history ring the daemon's sampler feeds and the
#: ``history`` request reports from
HISTORY = MetricsHistory()


def configure_history(capacity: Optional[int]) -> MetricsHistory:
    """Set the global ring's capacity (daemon startup / tests)."""
    if capacity is not None:
        HISTORY.resize(capacity)
    return HISTORY
