"""Elastic fleet policy: telemetry-driven autoscaling + brownout ladder.

The port's copy of ``tpulab.autoscale``.  The daemon's fleet layer keeps
N ``PagedEngine`` replicas warm; the autoscaler makes N *dynamic*.  This
module is the POLICY half of that loop — pure stdlib, no threads, no
clocks of its own (the caller passes
``now_s``) — so every scaling and brownout decision is unit-testable
without building an engine:

* :class:`AutoscalePolicy` — a target-replica controller fed one
  :class:`Signals` snapshot per sampler tick (queue-wait p99 from the
  history window, SLO burn-rate alert states, shed rate, per-replica
  load).  It moves an integer ``target`` one step at a time inside
  ``[min_replicas, max_replicas]``, with per-direction cooldowns and
  consecutive-evidence streaks (flap hysteresis) so one noisy tick —
  or a flapping alert — never oscillates the fleet.  The daemon owns
  RECONCILIATION (spawning/retiring replicas until actual == target);
  the policy owns only where target should be.

* :class:`BrownoutLadder` — the reversible degradation ladder between
  "healthy" and "shed".  Under sustained pressure it engages one rung
  per tick, in order::

      1 hedging_off     stop duplicating slow requests onto peers
      2 spec_off        no speculative decoding for NEW admissions
      3 token_cap       cap per-request max output tokens
      4 deadline_tight  tighten the admission deadline slack

  and releases the rungs in REVERSE order as pressure decays — each
  transition is a counted, observable state change (the daemon mirrors
  ``level`` into the ``daemon_brownout_level`` gauge and counts every
  engage/release).  Rungs 1–2 are byte-neutral for greedy traffic
  (hedge winners and speculative decode are both bit-identical to
  plain decode); rungs 3–4 trade work for admission headroom.

The daemon gathers the signal snapshot under its own locks and applies
the returned decisions; nothing here blocks or sleeps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: the brownout rungs in ENGAGE order (``level`` N means rungs
#: ``LADDER[:N]`` are active); release pops in reverse order
LADDER = ("hedging_off", "spec_off", "token_cap", "deadline_tight")

#: default admission-deadline slack multiplier at the
#: ``deadline_tight`` rung: a request is shed unless the observed
#: queue-wait p99 fits in HALF its deadline budget (the full budget
#: must cover decode too once the fleet is this pressured)
DEFAULT_DEADLINE_SLACK = 0.5


@dataclass(frozen=True)
class Signals:
    """One sampler tick's pressure evidence, snapshotted by the daemon.

    ``active_replicas`` counts serving (non-retired) replicas;
    ``load_per_replica`` is (queued + active requests) / active
    replicas; ``queue_wait_p99_s`` is the history-window p99 (None
    when the window holds no queue-wait samples yet); ``shed_rate``
    is sheds/s over the window; ``alerts_firing`` counts FIRING
    pressure alerts (the burn-rate rules the daemon feeds in).

    ``latency_p99_s`` (disaggregated pools) carries a
    pool-specific latency percentile — the daemon feeds ITL p99 for a
    decode pool, leaves it None for prefill/unified pools (whose
    pressure signal stays queue-wait).  Only policies constructed
    with ``latency_high_s`` act on it."""

    active_replicas: int
    load_per_replica: float = 0.0
    queue_wait_p99_s: Optional[float] = None
    shed_rate: float = 0.0
    alerts_firing: int = 0
    latency_p99_s: Optional[float] = None


class AutoscalePolicy:
    """Target-replica controller with bounds, cooldowns, hysteresis.

    Not thread-safe by design (the daemon calls it from the one
    sampler tick; tests drive it single-threaded).

    Overload evidence — ANY of: a firing pressure alert, a nonzero
    shed rate, queue-wait p99 at/above ``queue_wait_high_s``, or
    per-replica load at/above ``load_high``.  Underload evidence —
    ALL of: no alert, no sheds, queue-wait p99 below half the high
    mark (or no samples), and load at/below ``load_low``.  A tick
    that is neither resets BOTH streaks: ambiguous evidence must not
    creep the fleet in either direction.

    ``out_after`` consecutive overloaded ticks raise ``target`` one
    step (bounded by ``max_replicas``, rate-limited by
    ``out_cooldown_s``); ``in_after`` consecutive underloaded ticks
    lower it one step (bounded by ``min_replicas``, rate-limited by
    ``in_cooldown_s``, and additionally held off within
    ``in_cooldown_s`` of the LAST scale-out — capacity the burst just
    demanded is not returned on the first quiet tick)."""

    def __init__(self, min_replicas: int, max_replicas: int, *,
                 load_high: float = 4.0, load_low: float = 1.0,
                 queue_wait_high_s: float = 0.5,
                 latency_high_s: Optional[float] = None,
                 out_after: int = 2, in_after: int = 4,
                 out_cooldown_s: float = 2.0, in_cooldown_s: float = 6.0):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= min_replicas "
                f"({min_replicas})")
        if load_low > load_high:
            raise ValueError(
                f"load_low ({load_low}) must be <= load_high ({load_high})")
        if out_after < 1 or in_after < 1:
            raise ValueError("out_after and in_after must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.load_high = float(load_high)
        self.load_low = float(load_low)
        self.queue_wait_high_s = float(queue_wait_high_s)
        if latency_high_s is not None and latency_high_s <= 0:
            raise ValueError(
                f"latency_high_s must be > 0, got {latency_high_s}")
        #: optional pool-latency threshold (disaggregated pools): a decode pool's
        #: policy arms this with the ITL burn mark; None (the default,
        #: and every unified-fleet caller) ignores Signals.latency_p99_s
        self.latency_high_s = (None if latency_high_s is None
                               else float(latency_high_s))
        self.out_after = int(out_after)
        self.in_after = int(in_after)
        self.out_cooldown_s = float(out_cooldown_s)
        self.in_cooldown_s = float(in_cooldown_s)
        self.target = self.min_replicas
        self._hot = 0
        self._cold = 0
        self._last_out_s: Optional[float] = None
        self._last_in_s: Optional[float] = None
        #: lifetime target moves (the ``autoscale`` status surfaces
        #: them so an operator can see the controller working)
        self.raises = 0
        self.lowers = 0

    def overloaded(self, sig: Signals) -> bool:
        """One tick's overload evidence (also the brownout ladder's
        pressure input — "stepped by the same signals")."""
        if sig.alerts_firing > 0 or sig.shed_rate > 0:
            return True
        if (sig.queue_wait_p99_s is not None
                and sig.queue_wait_p99_s >= self.queue_wait_high_s):
            return True
        if (self.latency_high_s is not None
                and sig.latency_p99_s is not None
                and sig.latency_p99_s >= self.latency_high_s):
            return True
        return sig.load_per_replica >= self.load_high

    def underloaded(self, sig: Signals) -> bool:
        if sig.alerts_firing > 0 or sig.shed_rate > 0:
            return False
        if (sig.queue_wait_p99_s is not None
                and sig.queue_wait_p99_s >= 0.5 * self.queue_wait_high_s):
            return False
        if (self.latency_high_s is not None
                and sig.latency_p99_s is not None
                and sig.latency_p99_s >= 0.5 * self.latency_high_s):
            # same half-mark hysteresis as queue-wait: a pool whose
            # latency sits between half and full threshold is
            # ambiguous, not shrinkable
            return False
        return sig.load_per_replica <= self.load_low

    def observe(self, now_s: float, sig: Signals) -> int:
        """Fold one tick of evidence; returns the (possibly moved)
        target replica count."""
        hot = self.overloaded(sig)
        cold = self.underloaded(sig)
        if hot:
            self._hot += 1
            self._cold = 0
        elif cold:
            self._cold += 1
            self._hot = 0
        else:
            # ambiguous tick: neither direction accumulates evidence
            self._hot = self._cold = 0
        if (hot and self._hot >= self.out_after
                and self.target < self.max_replicas
                and (self._last_out_s is None
                     or now_s - self._last_out_s >= self.out_cooldown_s)):
            self.target += 1
            self.raises += 1
            self._last_out_s = now_s
            self._hot = 0
        elif (cold and self._cold >= self.in_after
                and self.target > self.min_replicas
                and (self._last_in_s is None
                     or now_s - self._last_in_s >= self.in_cooldown_s)
                and (self._last_out_s is None
                     or now_s - self._last_out_s >= self.in_cooldown_s)):
            self.target -= 1
            self.lowers += 1
            self._last_in_s = now_s
            self._cold = 0
        return self.target

    def snapshot(self) -> dict:
        return {"target": self.target,
                "min": self.min_replicas, "max": self.max_replicas,
                "raises": self.raises, "lowers": self.lowers,
                "hot_streak": self._hot, "cold_streak": self._cold}


class BrownoutLadder:
    """The reversible degradation ladder (levels ``0..len(LADDER)``).

    ``engage_after`` consecutive pressure ticks engage the next rung;
    ``release_after`` consecutive calm ticks release the last-engaged
    rung — strictly one rung per tick in each direction, so the
    ladder always unwinds through the exact states it climbed.
    ``step_cooldown_s`` rate-limits successive moves in the SAME
    direction, and a release is additionally held off within
    ``step_cooldown_s`` of the last engage (a one-tick pressure gap
    must not flap rung state).  Not thread-safe by design — same
    single-writer discipline as :class:`AutoscalePolicy`."""

    def __init__(self, *, engage_after: int = 2, release_after: int = 4,
                 step_cooldown_s: float = 1.0, token_cap: int = 64,
                 deadline_slack: float = DEFAULT_DEADLINE_SLACK):
        if engage_after < 1 or release_after < 1:
            raise ValueError("engage_after and release_after must be >= 1")
        if token_cap < 1:
            raise ValueError(f"token_cap must be >= 1, got {token_cap}")
        if not 0.0 < deadline_slack <= 1.0:
            raise ValueError(
                f"deadline_slack must be in (0, 1], got {deadline_slack}")
        self.engage_after = int(engage_after)
        self.release_after = int(release_after)
        self.step_cooldown_s = float(step_cooldown_s)
        self.token_cap = int(token_cap)
        self.deadline_slack = float(deadline_slack)
        self.level = 0
        self._hot = 0
        self._calm = 0
        self._last_engage_s: Optional[float] = None
        self._last_release_s: Optional[float] = None
        #: lifetime transition counts (mirrored into the daemon's
        #: ``daemon_brownout_steps`` / ``daemon_brownout_reversals``)
        self.engages = 0
        self.releases = 0

    def observe(self, now_s: float, pressure: bool) -> Optional[str]:
        """Fold one tick of pressure evidence.  Returns the transition
        taken — ``"engage:<rung>"`` / ``"release:<rung>"`` — or None."""
        if pressure:
            self._hot += 1
            self._calm = 0
            if (self.level < len(LADDER)
                    and self._hot >= self.engage_after
                    and (self._last_engage_s is None
                         or now_s - self._last_engage_s
                         >= self.step_cooldown_s)):
                rung = LADDER[self.level]
                self.level += 1
                self.engages += 1
                self._last_engage_s = now_s
                self._hot = 0
                return f"engage:{rung}"
            return None
        self._calm += 1
        self._hot = 0
        if (self.level > 0 and self._calm >= self.release_after
                and (self._last_release_s is None
                     or now_s - self._last_release_s >= self.step_cooldown_s)
                and (self._last_engage_s is None
                     or now_s - self._last_engage_s >= self.step_cooldown_s)):
            self.level -= 1
            self.releases += 1
            self._last_release_s = now_s
            self._calm = 0
            return f"release:{LADDER[self.level]}"
        return None

    @property
    def hedging_disabled(self) -> bool:
        return self.level >= 1

    @property
    def spec_disabled(self) -> bool:
        return self.level >= 2

    def cap_steps(self, steps: int) -> int:
        """Rung 3: cap a new admission's max output tokens."""
        if self.level >= 3:
            return min(int(steps), self.token_cap)
        return int(steps)

    def tighten_deadline_ms(self, deadline_ms):
        """Rung 4: shrink the admission deadline budget so the
        queue-wait shed check demands ``deadline_slack`` headroom.
        Deadline-free requests stay deadline-free (they opted out of
        shedding; brownout must not opt them in)."""
        if deadline_ms is None or self.level < 4:
            return deadline_ms
        return float(deadline_ms) * self.deadline_slack

    def snapshot(self) -> dict:
        return {"level": self.level,
                "rungs": list(LADDER[:self.level]),
                "engages": self.engages, "releases": self.releases}
