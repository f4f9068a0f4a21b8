"""Declarative alerting over the metrics history ring.

The port's copy of ``tpulab.obs.alerts``.  The history module
(:mod:`tpulab_torch.obs.history`) gives every metric a
time dimension; this module is the judgment layer on top: a small rule
engine the daemon's sampler evaluates once per tick, turning windowed
telemetry into operator-grade signals with the state machine production
alerting uses —

    ok -> pending (condition active, ``for_s`` not yet served)
       -> firing  (condition held for ``for_s``; tracer event, counter,
                   and — for page severity — a flight-recorder bundle)
       -> resolved (condition clear for ``keep_firing_s``: the flap
                   hysteresis — one good sample inside a burn must not
                   flap the alert) -> pending/firing again, or stays
                   resolved as the "recently recovered" display state.

Rule kinds:

* :class:`ThresholdRule` — compare one windowed aggregate (gauge value,
  gauge ratio, counter rate/delta, histogram window percentile) against
  a bound.  Covers the recompile tripwire (``engine_recompiles`` delta
  > 0) and the device-memory/KV occupancy gauges.
* :class:`AbsenceRule` — a metric that is missing entirely, or has not
  changed for ``stale_s`` despite the ring spanning that long
  (staleness); :class:`SamplerStaleRule` is the self-watching variant
  over the history ring's own age.
* :class:`BurnRateRule` — SRE-style multi-window burn rate over an SLO
  budget.  For a latency objective ("``objective`` of requests see
  ``metric`` <= ``budget_s``") the windowed error rate is
  ``1 - fraction_le(budget)``; for a ratio objective (shed rate) it is
  ``bad / (bad + good)``.  The burn rate is error-rate over the
  allowed error budget ``(1 - objective)``, and the rule fires only
  when BOTH the long and the short window burn at >= ``burn``x — the
  long window gives significance, the short window proves the burn is
  still happening (so a resolved incident stops paging without waiting
  for the long window to drain).  Ship a fast pair (60 s/15 s at 14.4x)
  and a slow pair (300 s/60 s at 6x) per SLO, the classic two-window
  ladder.
* :class:`ReplicaStallRule` — the fleet-health bridge: windowed
  slow-tick fraction of ONE replica (the ``fleet_replica<i>_*``
  counters the fleet stepper records), whose firing state the daemon
  maps onto the router's health machine (``ReplicaHealth.note_alert``)
  so a degraded replica is steered away from BEFORE it crashes.

Evaluation is sampler-tick cadence (never per request): each rule keeps
one reusable bucket-scratch list, so a full catalog evaluation
allocates almost nothing.  ``obs_alerts_*`` counters/gauges expose the
engine's own activity in every scrape, transitions emit tracer events
(``alert.pending`` / ``alert.firing`` / ``alert.resolved``), and a
page-severity firing records a flight-recorder bundle
(:mod:`tpulab_torch.obs.flightrec`) with the full windowed evidence — the
alert IS the crash dump for budget burns that never segfault.

The shipped catalog (:func:`default_rules`) is ``tpulab``'s, rule for
rule (tests/test_torch_obs_alerts.py holds the two catalogs equal), so
``docs/ARCHITECTURE.md``'s rule table describes both.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tpulab_torch.obs import registry as _reg
from tpulab_torch.obs.history import HISTORY, MetricsHistory, Window
from tpulab_torch.obs.tracer import TRACER

#: alert states (string-valued: they serialize into the daemon's
#: ``alerts`` JSON and the console table as-is)
OK = "ok"
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

#: severities, mildest first.  ``page`` additionally records a
#: flight-recorder bundle at the moment of firing.
SEVERITIES = ("info", "warn", "page")

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

#: engine counters/gauges: the alert engine's own observability
C_EVALS = _reg.counter(
    "obs_alerts_evals", "alert-engine evaluation passes (sampler ticks)")
C_FIRED = _reg.counter(
    "obs_alerts_fired", "alert transitions into FIRING")
C_RESOLVED = _reg.counter(
    "obs_alerts_resolved", "alert transitions FIRING -> RESOLVED")
G_FIRING = _reg.gauge(
    "obs_alerts_firing", "alert rules currently FIRING")
G_PENDING = _reg.gauge(
    "obs_alerts_pending", "alert rules currently PENDING")


class _Ctx:
    """One evaluation pass's shared state: the history ring, the
    evaluation instant, and a per-pass window cache so ten rules over
    the same 60 s window difference the samples once."""

    __slots__ = ("history", "now", "_windows")

    def __init__(self, history: MetricsHistory, now: float):
        self.history = history
        self.now = now
        self._windows: Dict[float, Optional[Window]] = {}

    def window(self, seconds: float) -> Optional[Window]:
        w = self._windows.get(seconds)
        if w is None and seconds not in self._windows:
            w = self.history.window(seconds)
            self._windows[seconds] = w
        return w


class Rule:
    """Base rule: subclasses implement :meth:`probe` returning
    ``(active, value, detail)``.  ``value`` is the headline number the
    snapshot shows (None when the rule cannot evaluate yet); ``detail``
    is a short human-readable explanation."""

    def __init__(self, name: str, *, severity: str = "warn",
                 for_s: float = 0.0, keep_firing_s: float = 0.0,
                 description: str = "", doc_name: Optional[str] = None):
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {severity!r}")
        if for_s < 0 or keep_firing_s < 0:
            raise ValueError("for_s and keep_firing_s must be >= 0")
        self.name = name
        self.severity = severity
        self.for_s = float(for_s)
        self.keep_firing_s = float(keep_firing_s)
        self.description = description
        #: the docs-lint anchor: dynamically-instantiated rules (one
        #: per replica) share one documented base name
        self.doc_name = doc_name or name

    def probe(self, ctx: _Ctx) -> Tuple[bool, Optional[float], str]:
        raise NotImplementedError


class ThresholdRule(Rule):
    """``agg(metric[, denom_metric]) op threshold`` over one window.

    ``agg``: ``"gauge"`` (latest value; with ``denom_metric`` the
    gauge/gauge ratio, inactive while the denominator is <= 0 — a CPU
    proxy without an HBM limit must not fire an occupancy page),
    ``"rate"`` (counter per-second increase over ``window_s``),
    ``"delta"`` (counter increase over ``window_s``), or ``"pNN"``
    (histogram percentile over ``window_s``, e.g. ``"p99"``)."""

    def __init__(self, name: str, metric: str, op: str, threshold: float,
                 *, agg: str = "gauge", window_s: float = 60.0,
                 denom_metric: Optional[str] = None,
                 min_count: int = 1, **kw):
        super().__init__(name, **kw)
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if agg not in ("gauge", "rate", "delta") and not (
                agg.startswith("p") and agg[1:].isdigit()):
            raise ValueError(f"unknown agg {agg!r}")
        if denom_metric is not None and agg != "gauge":
            raise ValueError("denom_metric only composes with agg='gauge'")
        self.metric = metric
        self.op = op
        self.threshold = float(threshold)
        self.agg = agg
        self.window_s = float(window_s)
        self.denom_metric = denom_metric
        self.min_count = int(min_count)
        self._scratch: List[int] = []

    def probe(self, ctx: _Ctx):
        w = ctx.window(self.window_s)
        if w is None:
            return False, None, "no samples yet"
        if self.agg == "gauge":
            v = w.gauge(self.metric)
            if self.denom_metric is not None:
                d = w.gauge(self.denom_metric)
                if d <= 0:
                    return False, None, f"{self.denom_metric}=0 (n/a)"
                v = v / d
        elif self.agg == "rate":
            v = w.rate(self.metric)
        elif self.agg == "delta":
            v = w.delta(self.metric)
        else:
            if w.count(self.metric) < self.min_count:
                return False, None, (f"{self.metric}: <{self.min_count} "
                                     f"observations in window")
            q = int(self.agg[1:]) / 100.0
            v = w.percentile(self.metric, q, self._scratch)
        active = _OPS[self.op](v, self.threshold)
        return active, v, (f"{self.agg}({self.metric})={v:.6g} "
                           f"{self.op} {self.threshold:g} "
                           f"over {w.duration_s:.0f}s")


class AbsenceRule(Rule):
    """A metric that is absent from the newest sample, or — with
    ``stale_s`` — present but unchanged for longer than ``stale_s``
    while the ring can actually prove it (a ring spanning less than
    ``stale_s`` stays inactive rather than guessing)."""

    def __init__(self, name: str, metric: str, *,
                 stale_s: Optional[float] = None, **kw):
        super().__init__(name, **kw)
        self.metric = metric
        self.stale_s = None if stale_s is None else float(stale_s)

    def probe(self, ctx: _Ctx):
        retained = ctx.history.retained()
        if not retained:
            return False, None, "no samples yet"
        t1, newest = retained[-1]
        m = newest.get(self.metric)
        if m is None:
            return True, None, f"{self.metric} absent from registry"
        if self.stale_s is None:
            return False, None, f"{self.metric} present"
        if t1 - retained[0][0] < self.stale_s:
            return False, None, (f"ring spans "
                                 f"{t1 - retained[0][0]:.0f}s < stale_s")
        cur = (m["count"] if m.get("type") == "histogram"
               else m["value"])
        changed_t = retained[0][0]
        for t, snap in reversed(retained[:-1]):
            pm = snap.get(self.metric)
            pv = (None if pm is None else
                  pm["count"] if pm.get("type") == "histogram"
                  else pm["value"])
            if pv != cur:
                changed_t = t
                break
        else:
            changed_t = retained[0][0]
        age = t1 - changed_t
        return (age > self.stale_s, age,
                f"{self.metric} unchanged for {age:.0f}s "
                f"(stale_s={self.stale_s:g})")


class SamplerStaleRule(Rule):
    """The history ring's own heartbeat: fires when the newest sample
    is older than ``max_age_s`` (or ``age_intervals`` x the sampler's
    configured cadence, when one is known) — which can only be observed
    from OUTSIDE the sampler, i.e. when an ``alerts`` request evaluates
    while the sampler thread is wedged or disabled."""

    def __init__(self, name: str = "sampler_stale", *,
                 max_age_s: float = 30.0, age_intervals: float = 10.0,
                 **kw):
        kw.setdefault("severity", "warn")
        super().__init__(name, **kw)
        self.max_age_s = float(max_age_s)
        self.age_intervals = float(age_intervals)

    def probe(self, ctx: _Ctx):
        age = ctx.history.age_s(ctx.now)
        if age is None:
            return False, None, "no samples yet"
        limit = self.max_age_s
        if ctx.history.interval_s:
            limit = min(limit, self.age_intervals
                        * ctx.history.interval_s)
        return (age > limit, age,
                f"newest sample {age:.1f}s old (limit {limit:g}s)")


class BurnRateRule(Rule):
    """Multi-window SLO burn rate (see module docstring).

    Latency mode: ``metric`` (a histogram) + ``budget_s`` — the error
    rate is the windowed fraction of observations over budget.  Ratio
    mode: ``bad_metric`` / (``bad_metric`` + ``good_metric``) counter
    deltas.  Either way ``burn = error_rate / (1 - objective)`` and
    the rule is active when both windows burn at >= ``burn``x.
    Windows with fewer than ``min_count`` eligible events contribute
    zero error (no traffic burns no budget — an idle daemon never
    pages)."""

    def __init__(self, name: str, *, objective: float = 0.99,
                 metric: Optional[str] = None,
                 budget_s: Optional[float] = None,
                 bad_metric: Optional[str] = None,
                 good_metric: Optional[str] = None,
                 long_s: float = 300.0, short_s: float = 60.0,
                 burn: float = 6.0, min_count: int = 1, **kw):
        kw.setdefault("keep_firing_s", short_s)
        super().__init__(name, **kw)
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0,1), got {objective}")
        latency = metric is not None
        ratio = bad_metric is not None
        if latency == ratio:
            raise ValueError("exactly one of metric+budget_s (latency) or "
                             "bad_metric+good_metric (ratio) is required")
        if latency and budget_s is None:
            raise ValueError("latency mode needs budget_s")
        if ratio and good_metric is None:
            raise ValueError("ratio mode needs good_metric")
        if short_s >= long_s:
            raise ValueError(f"short_s ({short_s}) must be < long_s "
                             f"({long_s})")
        self.objective = float(objective)
        self.metric = metric
        self.budget_s = None if budget_s is None else float(budget_s)
        self.bad_metric = bad_metric
        self.good_metric = good_metric
        self.long_s = float(long_s)
        self.short_s = float(short_s)
        self.burn = float(burn)
        self.min_count = int(min_count)
        self._scratch: List[int] = []

    def _error_rate(self, w: Window) -> Tuple[float, int]:
        """(windowed error rate, eligible events) for one window."""
        if self.metric is not None:
            n = w.count(self.metric)
            if n < self.min_count:
                return 0.0, n
            return 1.0 - w.fraction_le(self.metric, self.budget_s,
                                       self._scratch), n
        bad = w.delta(self.bad_metric)
        good = w.delta(self.good_metric)
        total = bad + good
        if total < self.min_count:
            return 0.0, int(total)
        return bad / total, int(total)

    def burn_rates(self, ctx: _Ctx
                   ) -> Optional[Tuple[float, float, int, int]]:
        """(long burn, short burn, long events, short events), or None
        before any sample exists — exposed for tests of the window
        arithmetic itself."""
        wl = ctx.window(self.long_s)
        ws = ctx.window(self.short_s)
        if wl is None or ws is None:
            return None
        budget = 1.0 - self.objective
        el, nl = self._error_rate(wl)
        es, ns = self._error_rate(ws)
        return el / budget, es / budget, nl, ns

    def probe(self, ctx: _Ctx):
        rates = self.burn_rates(ctx)
        if rates is None:
            return False, None, "no samples yet"
        bl, bs, nl, ns = rates
        active = bl >= self.burn and bs >= self.burn
        return active, bl, (
            f"burn {bl:.1f}x/{bs:.1f}x over {self.long_s:.0f}s/"
            f"{self.short_s:.0f}s (threshold {self.burn:g}x, "
            f"{nl}/{ns} events)")


class ReplicaStallRule(Rule):
    """Windowed degradation of ONE fleet replica: the fraction of its
    stepper ticks that were slow/stalled
    (``fleet<f>_replica<i>_slow_ticks`` over
    ``fleet<f>_replica<i>_ticks``, recorded by the fleet stepper —
    keyed by the fleet's process-unique id AND the replica index, so
    two warm fleets' same-index replicas never share a verdict)
    >= ``slow_frac`` with at least ``min_ticks`` ticks in the window.
    The daemon maps this rule's firing state onto
    ``ReplicaHealth.note_alert`` — placement steers off the replica
    while the alert is up, and the normal recovery hysteresis takes
    over once it resolves."""

    def __init__(self, index: int, *, fleet_id: int = 0,
                 window_s: float = 15.0, slow_frac: float = 0.5,
                 min_ticks: int = 2, **kw):
        kw.setdefault("severity", "warn")
        kw.setdefault("doc_name", "replica_degraded")
        super().__init__(
            kw.pop("name",
                   f"fleet{fleet_id}_replica{index}_degraded"), **kw)
        self.index = int(index)
        self.fleet_id = int(fleet_id)
        self.window_s = float(window_s)
        self.slow_frac = float(slow_frac)
        self.min_ticks = int(min_ticks)

    def probe(self, ctx: _Ctx):
        w = ctx.window(self.window_s)
        if w is None:
            return False, None, "no samples yet"
        base = f"fleet{self.fleet_id}_replica{self.index}"
        ticks = w.delta(f"{base}_ticks")
        slow = w.delta(f"{base}_slow_ticks")
        if ticks < self.min_ticks:
            return False, None, (f"{ticks:.0f} ticks in window "
                                 f"(<{self.min_ticks})")
        frac = slow / ticks
        return (frac >= self.slow_frac, frac,
                f"fleet{self.fleet_id} replica{self.index}: "
                f"{slow:.0f}/{ticks:.0f} slow ticks "
                f"({frac:.0%}) over {w.duration_s:.0f}s")


class AlertState:
    """One rule's live state (manager-lock guarded)."""

    __slots__ = ("state", "since", "fired_at", "resolved_at",
                 "clear_since", "value", "detail", "fires")

    def __init__(self):
        self.state = OK
        self.since: Optional[float] = None       # pending/firing entry
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.clear_since: Optional[float] = None  # firing, condition off
        self.value: Optional[float] = None
        self.detail = ""
        self.fires = 0


class AlertManager:
    """Holds the rule set and advances every rule's state machine per
    evaluation pass (the daemon's sampler tick).  Thread-safe: evaluate
    / add / snapshot serialize on one lock; evaluation never takes any
    other subsystem's lock (history and registry hand over copies)."""

    def __init__(self, rules: Sequence[Rule] = (),
                 page_postmortems: bool = False):
        self._lock = threading.Lock()
        self._rules: Dict[str, Rule] = {}
        self._states: Dict[str, AlertState] = {}
        #: record a flight-recorder bundle when a page-severity rule
        #: fires (the daemon enables this; standalone managers in
        #: tests/benches opt in explicitly)
        self.page_postmortems = bool(page_postmortems)
        for r in rules:
            self.add(r)

    def add(self, rule: Rule, replace: bool = False) -> Rule:
        with self._lock:
            if rule.name in self._rules and not replace:
                return self._rules[rule.name]
            self._rules[rule.name] = rule
            self._states[rule.name] = AlertState()
            return rule

    def remove(self, name: str) -> None:
        with self._lock:
            self._rules.pop(name, None)
            self._states.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
            self._states.clear()

    @property
    def rules(self) -> List[Rule]:
        with self._lock:
            return list(self._rules.values())

    def get_state(self, name: str) -> Optional[AlertState]:
        with self._lock:
            return self._states.get(name)

    # ----------------------------------------------------------- evaluate
    def evaluate(self, history: MetricsHistory = HISTORY,
                 now: Optional[float] = None) -> List[dict]:
        """One pass over every rule; returns the transition list
        ``[{"rule", "from", "to"}, ...]`` (empty most ticks).  State
        machine per rule: see the module docstring; transitions emit
        tracer events, bump the ``obs_alerts_*`` counters, and a page
        rule entering FIRING records a flight-recorder bundle with the
        full windowed evidence."""
        t = time.monotonic() if now is None else float(now)
        ctx = _Ctx(history, t)
        transitions: List[dict] = []
        fired_pages: List[dict] = []
        with self._lock:
            C_EVALS.inc()
            for name, rule in self._rules.items():
                st = self._states[name]
                try:
                    active, value, detail = rule.probe(ctx)
                except Exception as e:  # noqa: BLE001 — one broken rule
                    # must not silence the rest of the catalog; surface
                    # the failure in the rule's own detail string
                    active, value = False, None
                    detail = f"probe error: {type(e).__name__}: {e}"
                st.value = value
                st.detail = detail
                old = st.state
                if active:
                    st.clear_since = None
                    if st.state in (OK, RESOLVED):
                        st.state = PENDING
                        st.since = t
                    if st.state == PENDING and (
                            t - (st.since if st.since is not None else t)
                            >= rule.for_s):
                        st.state = FIRING
                        st.fired_at = t
                        st.resolved_at = None
                        st.fires += 1
                else:
                    if st.state == PENDING:
                        st.state = OK
                        st.since = None
                    elif st.state == FIRING:
                        if st.clear_since is None:
                            st.clear_since = t
                        if t - st.clear_since >= rule.keep_firing_s:
                            st.state = RESOLVED
                            st.resolved_at = t
                            st.since = None
                            st.clear_since = None
                if st.state != old:
                    transitions.append(
                        {"rule": name, "from": old, "to": st.state})
                    if st.state == PENDING:
                        TRACER.event("alert.pending", name)
                    elif st.state == FIRING:
                        TRACER.event("alert.firing", name)
                        C_FIRED.inc()
                        if (rule.severity == "page"
                                and self.page_postmortems):
                            fired_pages.append(
                                self._row_locked(name, t))
                    elif st.state == RESOLVED:
                        TRACER.event("alert.resolved", name)
                        C_RESOLVED.inc()
            G_FIRING.set(sum(1 for s in self._states.values()
                             if s.state == FIRING))
            G_PENDING.set(sum(1 for s in self._states.values()
                              if s.state == PENDING))
        for row in fired_pages:
            # flight recorder OUTSIDE the manager lock (it snapshots
            # the registry/tracer/slowlog and writes a file); it never
            # raises by contract
            from tpulab_torch.obs import flightrec

            flightrec.record_postmortem(
                f"alert_page:{row['rule']}", extra={"alert": row})
        return transitions

    # ----------------------------------------------------------- snapshot
    def _row_locked(self, name: str, now: Optional[float] = None) -> dict:
        rule = self._rules[name]
        st = self._states[name]
        t = time.monotonic() if now is None else now
        row = {
            "rule": name, "severity": rule.severity, "state": st.state,
            "value": st.value, "detail": st.detail, "fires": st.fires,
            "for_s": rule.for_s, "keep_firing_s": rule.keep_firing_s,
            "description": rule.description,
        }
        if st.state in (PENDING, FIRING) and st.since is not None:
            row["active_for_s"] = round(t - st.since, 3)
        if st.fired_at is not None and st.state == FIRING:
            row["firing_for_s"] = round(t - st.fired_at, 3)
        if st.resolved_at is not None and st.state == RESOLVED:
            row["resolved_ago_s"] = round(t - st.resolved_at, 3)
        return row

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The ``alerts`` request body: every rule's state row (firing
        first, then pending, resolved, ok; severity-major inside each)
        plus the firing/pending totals."""
        order = {FIRING: 0, PENDING: 1, RESOLVED: 2, OK: 3}
        sev = {s: i for i, s in enumerate(reversed(SEVERITIES))}
        with self._lock:
            rows = [self._row_locked(n, now) for n in self._rules]
        rows.sort(key=lambda r: (order[r["state"]], sev[r["severity"]],
                                 r["rule"]))
        return {
            "rules": len(rows),
            "firing": sum(1 for r in rows if r["state"] == FIRING),
            "pending": sum(1 for r in rows if r["state"] == PENDING),
            "alerts": rows,
        }

    def firing(self) -> List[dict]:
        """The currently-FIRING rows (the flight recorder attaches this
        set to every crash bundle — "what was already alerting when it
        died")."""
        return [r for r in self.snapshot()["alerts"]
                if r["state"] == FIRING]


def _env_ms(name: str, default_ms: float) -> float:
    """Env-tunable SLO budget in milliseconds -> seconds."""
    return float(os.environ.get(name, default_ms)) / 1e3


def default_rules(*, objective: Optional[float] = None,
                  ttft_budget_s: Optional[float] = None,
                  itl_budget_s: Optional[float] = None,
                  e2e_budget_s: Optional[float] = None,
                  queue_budget_s: Optional[float] = None) -> List[Rule]:
    """The shipped rule catalog (``tpulab``'s: every name below has an
    entry in docs/ARCHITECTURE.md's rule table).  Budgets default from
    the ``TPULAB_SLO_*`` environment so a deployment tunes objectives
    without code."""
    obj = (float(os.environ.get("TPULAB_SLO_OBJECTIVE", 0.99))
           if objective is None else objective)
    ttft = (_env_ms("TPULAB_SLO_TTFT_MS", 500.0)
            if ttft_budget_s is None else ttft_budget_s)
    itl = (_env_ms("TPULAB_SLO_ITL_MS", 200.0)
           if itl_budget_s is None else itl_budget_s)
    e2e = (_env_ms("TPULAB_SLO_E2E_MS", 5000.0)
           if e2e_budget_s is None else e2e_budget_s)
    qw = (_env_ms("TPULAB_SLO_QUEUE_MS", 250.0)
          if queue_budget_s is None else queue_budget_s)
    return [
        # -- the two-window burn ladder per latency SLO --------------
        BurnRateRule("ttft_burn_fast", severity="page", objective=obj,
                     metric="ttft_seconds", budget_s=ttft,
                     long_s=60, short_s=15, burn=14.4,
                     description=f"TTFT error budget (<= {ttft * 1e3:g}ms "
                                 f"for {obj:.0%}) burning >= 14.4x"),
        BurnRateRule("ttft_burn_slow", severity="warn", objective=obj,
                     metric="ttft_seconds", budget_s=ttft,
                     long_s=300, short_s=60, burn=6.0,
                     description="TTFT error budget burning >= 6x over "
                                 "5m/1m"),
        BurnRateRule("itl_burn_fast", severity="warn", objective=obj,
                     metric="itl_seconds", budget_s=itl,
                     long_s=60, short_s=15, burn=14.4,
                     description=f"inter-token-latency budget "
                                 f"(<= {itl * 1e3:g}ms) burning >= 14.4x"),
        BurnRateRule("e2e_burn_fast", severity="warn", objective=obj,
                     metric="e2e_seconds", budget_s=e2e,
                     long_s=60, short_s=15, burn=14.4,
                     description=f"end-to-end budget (<= {e2e:g}s) "
                                 f"burning >= 14.4x"),
        BurnRateRule("queue_wait_burn_fast", severity="page",
                     objective=obj, metric="queue_wait_seconds",
                     budget_s=qw, long_s=60, short_s=15, burn=14.4,
                     description=f"queue-wait budget (<= {qw * 1e3:g}ms) "
                                 f"burning >= 14.4x — admission is "
                                 f"falling behind"),
        # -- goodput: shed fraction against an availability objective -
        BurnRateRule("goodput_shed_burn", severity="warn", objective=obj,
                     bad_metric="daemon_shed_requests",
                     good_metric="engine_requests_done",
                     long_s=60, short_s=15, burn=14.4,
                     description="shed fraction of completed+shed "
                                 "requests burning the availability "
                                 "budget >= 14.4x"),
        # -- tripwires over the build-ledger/capacity gauges ------------
        ThresholdRule("recompile_tripwire", "engine_recompiles", ">", 0,
                      agg="delta", window_s=60, severity="page",
                      keep_firing_s=60,
                      description="a fresh run-time build landed inside "
                                  "a steady-state engine step in the last "
                                  "minute (fixed-shape discipline broke)"),
        ThresholdRule("engine_restart_alert", "daemon_engine_restarts",
                      ">", 0, agg="delta", window_s=60, severity="page",
                      keep_firing_s=60,
                      description="an engine/replica step loop was "
                                  "quarantined and rebuilt in the last "
                                  "minute"),
        ThresholdRule("hbm_occupancy_high", "engine_hbm_bytes_in_use",
                      ">=", 0.92, agg="gauge",
                      denom_metric="engine_hbm_bytes_limit",
                      for_s=5, keep_firing_s=10, severity="warn",
                      description="device HBM >= 92% of the backend-"
                                  "reported limit (inactive on the CPU "
                                  "proxy, which reports no limit)"),
        ThresholdRule("kv_occupancy_high", "engine_blocks_used",
                      ">=", 0.95, agg="gauge",
                      denom_metric="engine_blocks_total",
                      for_s=5, keep_firing_s=10, severity="warn",
                      description="KV pool >= 95% of its blocks "
                                  "allocated — preemption/shed pressure "
                                  "imminent"),
        # -- the telemetry layer watching itself ----------------------
        SamplerStaleRule("sampler_stale", max_age_s=30.0,
                         age_intervals=10.0, severity="warn",
                         keep_firing_s=5,
                         description="the metrics sampler has not "
                                     "appended a sample for 10 "
                                     "intervals — history and alerts "
                                     "are blind"),
    ]


#: the process-global manager the daemon's sampler evaluates and the
#: ``alerts`` request renders.  Ships EMPTY: the daemon installs the
#: default catalog at startup (install_default_rules) so library users
#: embedding an engine don't get page-severity rules they never asked
#: for.
ALERTS = AlertManager()


def install_default_rules(manager: AlertManager = ALERTS, **kw) -> None:
    """Add the shipped catalog to ``manager`` (existing names kept —
    operator-replaced rules are not clobbered)."""
    for rule in default_rules(**kw):
        manager.add(rule)
