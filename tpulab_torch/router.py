"""Fleet routing policy: replica health tracking + placement scoring.

The daemon's fleet layer (``tpulab_torch/daemon.py``, ``--replicas N``) keeps
N identical ``PagedEngine`` replicas warm per serving config.  This
module is the POLICY half of that layer — pure stdlib, no jax, no
threads — so the decisions the router makes are unit-testable without
building an engine:

* :class:`ReplicaHealth` — the per-replica health state machine

      HEALTHY -> SUSPECT -> (crash) QUARANTINED -> REBUILDING -> HEALTHY

  fed from signals the serving stack already produces: stepper tick
  durations (a wedged replica's ticks stretch — the ``slow_ms`` chaos
  signature), stall ticks from ``engine.stats()``, and step-loop
  crashes (dispatch exceptions and ``EngineIntegrityError`` tripwires
  both surface as a crash).  SUSPECT only *deprioritizes* a replica in
  placement (it still serves — a compile pause must not brown-out the
  fleet); QUARANTINED/REBUILDING exclude it entirely until the rebuild
  swaps a fresh engine in.

* :func:`choose_replica` — placement scoring over
  :class:`ReplicaView` snapshots: prefer non-SUSPECT replicas, then
  the best ``affinity_weight * prefix_affinity - load`` score
  (prefix-affinity = shared prompt-prefix blocks already resident in
  that replica's cache — sending the request there dedups the prefill
  the fleet already paid), ties broken least-loaded then lowest index.

The daemon gathers the views under its own locks and applies the
returned decision; DRAINING is daemon-side state (an operator drain is
not a health observation) and arrives here as ``placeable=False``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

#: health states (string-valued so they serialize straight into the
#: daemon's ``fleet`` JSON response and the obs_report table)
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
REBUILDING = "rebuilding"
#: round 17 (elastic fleet): the replica's engine was released — by a
#: scale-in or a spot preemption — and its slot idles empty until a
#: scale-out revives it through the rebuild lifecycle
RETIRED = "retired"

#: a stepper tick at or above this duration counts as SLOW — sized for
#: the chaos tier's wedge signature (``slow_ms`` >= 100ms on a
#: millisecond-tick CPU engine) while staying far above a healthy tick
DEFAULT_SLOW_TICK_S = 0.25


class ReplicaHealth:
    """Per-replica health state machine.

    Not thread-safe by design: the daemon guards every transition with
    its fleet condition (one lock, one writer discipline), and tests
    drive it single-threaded.

    ``suspect_after`` consecutive slow/stalled ticks demote HEALTHY ->
    SUSPECT; ``recover_after`` consecutive clean ticks promote SUSPECT
    -> HEALTHY (hysteresis: one fast tick inside a wedge must not
    flap the replica back into preferred placement).  A crash goes
    straight to QUARANTINED regardless of state; only the rebuild
    lifecycle (:meth:`note_rebuild_start` / :meth:`note_rebuilt`)
    leaves it."""

    def __init__(self, slow_tick_s: float = DEFAULT_SLOW_TICK_S,
                 suspect_after: int = 3, recover_after: int = 8):
        if slow_tick_s <= 0:
            raise ValueError(f"slow_tick_s must be > 0, got {slow_tick_s}")
        if suspect_after < 1 or recover_after < 1:
            raise ValueError("suspect_after and recover_after must be >= 1")
        self.slow_tick_s = float(slow_tick_s)
        self.suspect_after = int(suspect_after)
        self.recover_after = int(recover_after)
        self.state = HEALTHY
        self._slow = 0
        self._fast = 0
        #: True while a replica-degradation alert is FIRING for this
        #: replica (tpulab_torch.obs.alerts.ReplicaStallRule, applied by the
        #: daemon's sampler): telemetry-driven suspicion that both
        #: demotes and HOLDS the replica SUSPECT — see note_alert
        self.alert_firing = False
        #: lifetime transition counts (the ``fleet`` response surfaces
        #: them so an operator can see a replica flapping)
        self.suspects = 0
        self.crashes = 0

    @property
    def placeable(self) -> bool:
        """Whether placement may target this replica at all (SUSPECT
        still serves — just deprioritized)."""
        return self.state in (HEALTHY, SUSPECT)

    def note_tick(self, dt_s: float, stalled: bool = False) -> None:
        """One stepper tick took ``dt_s`` seconds; ``stalled`` marks a
        tick whose stats counted stall work (a decode slot starved) —
        both count as slow evidence.  Ignored outside HEALTHY/SUSPECT
        (a quarantined replica's trailing ticks prove nothing)."""
        if self.state not in (HEALTHY, SUSPECT):
            return
        if stalled or dt_s >= self.slow_tick_s:
            self._slow += 1
            self._fast = 0
            if self.state == HEALTHY and self._slow >= self.suspect_after:
                self.state = SUSPECT
                self.suspects += 1
        else:
            self._fast += 1
            self._slow = 0
            if (self.state == SUSPECT and self._fast >= self.recover_after
                    and not self.alert_firing):
                # a firing degradation alert HOLDS suspicion: the
                # windowed evidence outranks a streak of fast ticks
                # (the wedge signature alternates), and recovery waits
                # for the alert's own resolve hysteresis
                self.state = HEALTHY

    def note_alert(self, firing: bool) -> None:
        """Telemetry-driven SUSPECT (round 15, "alert-wired fleet
        health"): the daemon's sampler maps each replica's
        ``replica_degraded`` alert state here every tick.  A FIRING
        alert demotes HEALTHY -> SUSPECT immediately (windowed
        slow-tick evidence — the replica is steered away from BEFORE
        its crash path runs) and resets any recovery streak; while it
        stays firing, :meth:`note_tick`'s fast-tick promotion is held
        off.  Resolution does NOT instantly promote — the normal
        ``recover_after`` clean-tick hysteresis finishes the job, so a
        flapping alert cannot flap placement.  Ignored outside
        HEALTHY/SUSPECT (quarantine/rebuild own those states)."""
        if not firing:
            if self.alert_firing:
                # release edge: restart the clean-tick streak — ticks
                # that ran UNDER the firing alert are not recovery
                # evidence (the windowed rule just said otherwise)
                self._fast = 0
            self.alert_firing = False
            return
        self.alert_firing = True
        self._fast = 0
        if self.state == HEALTHY:
            self.state = SUSPECT
            self.suspects += 1

    def note_crash(self) -> None:
        """The replica's step loop died (dispatch exception or an
        integrity tripwire): QUARANTINED until rebuilt."""
        self.state = QUARANTINED
        self.crashes += 1
        self._slow = self._fast = 0

    def note_rebuild_start(self) -> None:
        self.state = REBUILDING

    def note_rebuild_failed(self) -> None:
        """The rebuild itself raised: back to QUARANTINED (the daemon
        may retry on the next failure-driven rebuild request)."""
        self.state = QUARANTINED

    def note_retired(self) -> None:
        """The replica's engine was RELEASED (autoscale scale-in, or a
        spot-preemption notice whose drain deadline expired): not a
        health observation — the slot simply holds no engine.  Tick
        and alert evidence are ignored while retired (both guard on
        HEALTHY/SUSPECT); only a scale-out revival
        (:meth:`note_rebuild_start` -> :meth:`note_rebuilt`) leaves."""
        self.state = RETIRED
        self._slow = self._fast = 0
        self.alert_firing = False

    def note_rebuilt(self) -> None:
        """A fresh engine was swapped in: fully healthy, counters
        reset (the new engine has produced no evidence yet; a stale
        alert against the DEAD engine's window does not transfer)."""
        self.state = HEALTHY
        self._slow = self._fast = 0
        self.alert_firing = False

    def snapshot(self) -> dict:
        return {"state": self.state, "suspects": self.suspects,
                "crashes": self.crashes,
                "alert_firing": self.alert_firing}


#: pool roles (round 20, disaggregated serving): which lifecycle phase
#: a replica serves.  ``unified`` replicas (the default — every fleet
#: before round 20) take both phases; a ``prefill`` replica admits new
#: requests and hands their KV off at the PREFILLING→DECODING edge; a
#: ``decode`` replica only receives those handoffs (plus decode-phase
#: migrations).  String-valued so roles serialize straight into the
#: ``fleet`` JSON response, like the health states above.
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_UNIFIED = "unified"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_UNIFIED)


@dataclass(frozen=True)
class ReplicaView:
    """One replica's placement-relevant state, snapshotted by the
    daemon under its locks: ``load`` = queued + active requests,
    ``affinity`` = shared prompt-prefix blocks already resident in the
    replica's prefix cache.  ``placeable=False`` covers QUARANTINED /
    REBUILDING health AND operator drain.  ``role`` is the pool role
    (phase-aware placement filters on it; ``unified`` matches every
    phase)."""

    index: int
    placeable: bool
    suspect: bool
    load: int
    affinity: int = 0
    role: str = ROLE_UNIFIED


def pool_counts(roles) -> dict:
    """Serving census per pool role: ``{"prefill": 2, "decode": 1}``
    from an iterable of role strings (``None``/empty count as
    ``unified`` — the pre-round-20 default).  Pure like everything in
    this module; the round-21 fleet table (``tpulab_torch.obs.render``)
    renders it next to each pool's configured band, and tests exercise
    it without a fleet."""
    out: dict = {}
    for role in roles:
        role = role or ROLE_UNIFIED
        out[role] = out.get(role, 0) + 1
    return out


def _role_serves(role: str, phase: Optional[str]) -> bool:
    """Whether a replica with ``role`` may take work for ``phase``
    (``None`` = phase-blind placement — the pre-round-20 behavior and
    the unified fleet's fast path)."""
    if phase is None or role == ROLE_UNIFIED:
        return True
    return role == phase


def choose_replica(views: Sequence[ReplicaView],
                   affinity_weight: float = 2.0,
                   phase: Optional[str] = None) -> Optional[int]:
    """Pick the replica index to place a request on, or None when no
    view is placeable (the caller parks or rejects).

    Policy: non-SUSPECT strictly preferred over SUSPECT (a wedged
    replica takes traffic only when every healthy one is unplaceable);
    within a tier, maximize ``affinity_weight * affinity - load``
    (prefix-affinity measured in blocks, load in requests — the weight
    says one resident shared block is worth eating two queued
    requests' wait); ties break least-loaded, then lowest index
    (deterministic for tests and for an idle fleet).

    ``phase`` extends the score to phase-aware placement (round 20):
    ``"prefill"`` restricts candidates to prefill + unified replicas
    (new admissions), ``"decode"`` to decode + unified (KV handoffs
    and decode-phase migrations).  A phase with zero matching
    placeable views returns None even when the OTHER pool has room —
    the caller distinguishes "pool empty" from "fleet empty" for its
    park frame."""
    best = None
    best_key = None
    for v in views:
        if not v.placeable or not _role_serves(v.role, phase):
            continue
        key = (v.suspect, -(affinity_weight * v.affinity - v.load),
               v.load, v.index)
        if best_key is None or key < best_key:
            best, best_key = v.index, key
    return best
