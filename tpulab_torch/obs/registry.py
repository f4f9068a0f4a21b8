"""Process-global metric registry: Counter / Gauge / fixed-bucket Histogram.

The serving and training loops were, until this module existed, observed
through flat cumulative counter dicts (``PagedEngine.stats()``, the
trainer's ``[train] counters`` line) — no latency distributions, no
single scrape surface.  Production serving comparisons report TTFT
and inter-token-latency *percentiles* as the primary serving metrics
(PAPERS.md, arXiv:2605.25645), and the reference harness itself is
built around measured-then-aggregated timing (``tpulab_torch/harness/tester``)
— this registry gives the framework that measurement discipline as a
first-class, dependency-free subsystem.

Design constraints (they shape every class below):

* **Hot-path cost is O(1) and allocation-free**: a ``Counter.inc`` is
  one locked integer add; a ``Histogram.observe`` is one ``bisect`` into
  a precomputed boundary tuple plus three integer/float adds.  No dict
  is built, no string formatted, no device touched — safe to call from
  inside the paged engine's drain loop and the trainer's dispatch loop
  without disturbing the engine's steady state (no added host wait).
* **Snapshots are copy-on-read**: every metric copies its state under
  its own lock, so a scrape racing a decode tick can never observe a
  torn histogram (count advanced, sum not — the daemon used to read
  engine stats outside any lock; see ``tpulab_torch/daemon.py``).
* **Prometheus text exposition** (`render_prometheus`): the de-facto
  scrape format, emitted without any client library — the daemon's
  ``metrics`` request returns exactly this text.

Default histogram buckets are exponential (powers of two from 0.1 ms),
suited to the ms-scale serving latencies the engine records; pass
explicit ``buckets`` for anything else.  Values are SECONDS by
convention (metric names end in ``_seconds``), matching Prometheus
practice.
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left
from typing import Dict, Iterable, Optional, Sequence, Tuple

#: exponential default buckets for ms-scale latencies: 0.1 ms .. ~105 s
#: (21 powers of two).  Upper bounds in SECONDS, strictly increasing.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(1e-4 * 2 ** i for i in range(21))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def percentile_from_buckets(bounds: Sequence[float],
                            counts: Sequence[int], q: float) -> float:
    """Estimate the ``q``-quantile (q in [0, 1]) from per-bucket counts.

    ``counts`` has ``len(bounds) + 1`` entries — the last is the
    overflow (+Inf) bucket.  Linear interpolation inside the bucket
    containing the target rank, exactly Prometheus's
    ``histogram_quantile`` rule; ranks landing in the overflow bucket
    clamp to the last finite bound (the estimate cannot exceed what the
    buckets resolve).  Returns 0.0 for an empty histogram.  Shared by
    :meth:`Histogram.percentile`, ``tools/obs_report.py`` (which works
    from scraped cumulative buckets), and the tests — one copy of the
    interpolation math.
    """
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"counts must have len(bounds)+1 = {len(bounds) + 1} entries "
            f"(incl. +Inf overflow), got {len(counts)}")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c and cum + c >= rank:
            if i >= len(bounds):      # overflow bucket: clamp
                return float(bounds[-1])
            lo = float(bounds[i - 1]) if i else 0.0
            hi = float(bounds[i])
            return lo + (hi - lo) * ((rank - cum) / c)
        cum += c
    return float(bounds[-1])


class Counter:
    """Monotonically increasing count (requests, events, errors)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "counter", "help": self.help,
                    "value": self._value}


class Gauge:
    """Instantaneous value (pool occupancy, in-flight depth)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "gauge", "help": self.help, "value": self._value}


class Histogram:
    """Fixed-bucket latency distribution.

    ``observe`` is the hot path: one bisect into the precomputed bounds
    tuple + three adds, under the metric's own lock (the lock is what
    makes :meth:`snapshot` copy-on-read un-tearable; uncontended
    acquisition is tens of ns — invisible next to the ~ms engine tick
    the ``obs_overhead`` bench budgets 3% of).  Bucket COUNTS are
    per-bucket here; the Prometheus exposition converts to cumulative
    ``le`` form at render time, off the hot path.
    """

    __slots__ = ("name", "help", "bounds", "_lock", "_counts", "_sum",
                 "_count", "_exemplars")

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.help = help
        bounds = tuple(float(b) for b in (buckets if buckets is not None
                                          else DEFAULT_BUCKETS))
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name} buckets must be non-empty and strictly "
                f"increasing, got {bounds}")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        # round 21 exemplars: at most ONE (rid, value) pair per bucket
        # — the newest observation that landed there.  Bounded by
        # construction (len(bounds)+1 slots), written under the same
        # lock as the counts, copied whole by snapshot(): a p99 bucket
        # therefore always points at a concrete, recent request whose
        # journey (tpulab_torch.obs.journey) explains the latency.
        self._exemplars: list = [None] * (len(bounds) + 1)

    def observe(self, v: float, rid: Optional[int] = None) -> None:
        i = bisect_left(self.bounds, v)
        if rid is None:
            with self._lock:
                self._counts[i] += 1
                self._sum += v
                self._count += 1
        else:
            ex = (rid, v)
            with self._lock:
                self._counts[i] += 1
                self._sum += v
                self._count += 1
                self._exemplars[i] = ex

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """Copy-on-read quantile estimate (see percentile_from_buckets)."""
        with self._lock:
            counts = list(self._counts)
        return percentile_from_buckets(self.bounds, counts, q)

    def snapshot(self) -> dict:
        """Consistent copy under the lock: counts, sum, and count all
        from the SAME instant — a scrape racing ``observe`` sees either
        all of an observation or none of it (the torn-histogram fix)."""
        with self._lock:
            return {"type": "histogram", "help": self.help,
                    "bounds": self.bounds, "counts": list(self._counts),
                    "sum": self._sum, "count": self._count,
                    "exemplars": list(self._exemplars)}


class Registry:
    """Name -> metric, get-or-create.  One process-global instance
    (:data:`REGISTRY`) backs the whole stack; tests build private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        if buckets is None:
            return self._get_or_create(Histogram, name, help)
        # normalize ONCE up front: the caller may pass a one-shot
        # iterator, which the conflict check below would otherwise
        # consume a second time (exhausted -> spurious mismatch)
        buckets = tuple(float(b) for b in buckets)
        h = self._get_or_create(Histogram, name, help, buckets=buckets)
        if h.bounds != buckets:
            # a silent get-or-create here would hand back the FIRST
            # registration's buckets and quietly mis-bucket every later
            # observation — conflicting resolutions are a hard error,
            # symmetric with the cross-type mismatch above
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.bounds}, conflicting with {buckets}")
        return h

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """Copy-on-read view of every metric (each copied under its own
        lock) — the ONE read path both exposition and tools go through,
        so no consumer can ever see a half-updated histogram."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(metrics)}

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4) of a snapshot."""
        out = []
        for name, snap in self.snapshot().items():
            if snap["help"]:
                out.append(f"# HELP {name} {snap['help']}")
            out.append(f"# TYPE {name} {snap['type']}")
            if snap["type"] == "histogram":
                # bucket exemplars use the OpenMetrics convention — a
                # trailing ``# {rid="N"} value`` — layered onto the
                # 0.0.4 text format; every in-repo parser
                # (tpulab_torch.obs.render.parse_prometheus) understands the
                # suffix, and exemplar-free output is byte-identical
                # to pre-round-21 exposition
                ex = snap.get("exemplars") or [None] * len(snap["counts"])
                cum = 0
                for b, c, e in zip(snap["bounds"], snap["counts"], ex):
                    cum += c
                    line = f'{name}_bucket{{le="{b:.10g}"}} {cum}'
                    if e is not None:
                        line += f' # {{rid="{e[0]}"}} {e[1]:.10g}'
                    out.append(line)
                cum += snap["counts"][-1]
                line = f'{name}_bucket{{le="+Inf"}} {cum}'
                if ex[-1] is not None:
                    out.append(line + f' # {{rid="{ex[-1][0]}"}} '
                                      f'{ex[-1][1]:.10g}')
                else:
                    out.append(line)
                out.append(f"{name}_sum {snap['sum']:.10g}")
                out.append(f"{name}_count {snap['count']}")
            else:
                v = snap["value"]
                out.append(f"{name} {v:.10g}" if isinstance(v, float)
                           else f"{name} {v}")
        return "\n".join(out) + "\n"


#: the process-global registry every subsystem records into and the
#: daemon's ``metrics`` request renders
REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Optional[Iterable[float]] = None) -> Histogram:
    return REGISTRY.histogram(name, help, buckets)


def render_prometheus() -> str:
    return REGISTRY.render()
