"""Deterministic fault injection for the serving path.

Production fault-tolerance code is only trustworthy if its failure
paths run on every CI pass, not just on the day a chip actually
misbehaves.  This module is the chaos layer the supervisor/preemption/
shedding machinery (tpulab_torch/daemon.py, tpulab_torch/models/paged.py) is
tested through: a **seeded, schedule-driven injector** that fires
specific fault kinds at **named sites** in the engine and daemon hot
paths — the n-th time a site is hit, deterministically, so a chaos
test replays the exact same failure sequence every run.

Design constraints:

* **Off by default, zero hot-path cost when disabled.**  Every site is
  guarded by the module-level :data:`ACTIVE` boolean — a disabled
  injector costs the hot path ONE global read and branch (the
  ``fault_overhead`` bench bounds even the *enabled-idle* bookkeeping
  under 1% of steady-state ticks/s, a strict upper bound on the
  disabled cost).  ``tests/test_faults.py`` additionally proves the
  disabled path never calls into this module at all.
* **Deterministic.**  A rule fires on hit counts of its site (``at``,
  ``count``), never on wall clock or unseeded randomness; the optional
  ``seed`` only feeds choices a rule explicitly delegates (none of the
  built-in kinds do today — it is carried so future kinds stay
  reproducible).
* **Thread-safe.**  Sites are hit from the daemon's per-engine stepper
  threads and connection handlers concurrently; hit counting is locked.

Sites wired in this round (grep for ``_FAULTS``/``faults.fire``):

=====================  =====================================================
``paged.step``         top of ``PagedEngine.step`` (kinds: ``raise``,
                       ``corrupt_table``)
``paged.tick``         just before the ``paged_tick`` dispatch (``raise`` —
                       the mid-wave dispatch-exception case)
``paged.drain``        after the drain's ``device_get`` (``nan_tokens`` —
                       models NaN logits surfacing as out-of-vocab tokens,
                       caught by the engine's validity tripwire;
                       ``slow_ms`` — a slow/hung host sync; ``raise``)
``daemon.step``        the daemon stepper loop, before ``engine.step()``
``daemon.send``        before a response/chunk ``sendall`` (``slow_ms`` —
                       a wedged client connection)
``daemon.kill``        after the journal accept record is durable, before
                       admission (``kill`` — deterministic process death;
                       subprocess-based tests only)
``replica.preempt``    the daemon stepper loop, alongside ``daemon.step``
                       (``preempt`` — a spot-preemption notice for that
                       replica; ``arg`` is the drain deadline in ms)
``daemon.handoff``     the disaggregated fleet's prefill→decode handoff
                       (round 20), between the prefill-side KV export
                       and the decode-side admit (``raise`` — the
                       supervisor drops the payload and replays from
                       the journaled prompt, charging the replay
                       budget; zero leaked blocks on either engine)
=====================  =====================================================

Fault kinds:

* ``raise``          — raise :class:`InjectedFault` at the site;
* ``nan_tokens``     — site corrupts its fetched token vector (the
  deterministic stand-in for NaN logits: real NaNs argmax to an
  arbitrary-but-valid id, so the injector substitutes an *invalid* one
  and the engine's always-on token validity check trips);
* ``corrupt_table``  — site writes an out-of-range physical block into
  a slot table (the engine's release-time integrity check trips);
* ``slow_ms``        — sleep ``arg`` milliseconds at the site (slow or
  wedged host sync / client socket);
* ``kill``           — ``os._exit(arg or 1)`` at the site: instant
  process death with no cleanup (the SIGKILL/OOM/preemption stand-in
  the write-ahead journal recovers from).  Fire it only in a daemon
  SUBPROCESS — in-process it kills the test runner.
* ``preempt``        — a SPOT-PREEMPTION NOTICE, returned for the site
  to apply (only the daemon's fleet layer knows how to drain a
  replica): the replica gets ``arg`` milliseconds (default 2000) to
  migrate what it can to peers before it is released; stragglers park
  for the journal/recovery path.  Unlike ``kill``, the notice-then-
  deadline shape is the cloud spot contract, and it is safe in-process.

Schedules are lists of rule dicts::

    faults.configure([
        {"site": "paged.tick", "kind": "raise", "at": 5},
        {"site": "paged.drain", "kind": "slow_ms", "at": 2,
         "count": 3, "arg": 50.0},
    ], seed=0)

``at`` is the 1-based hit index of the SITE at which the rule starts
firing; ``count`` (default 1) is how many consecutive hits it fires
for.  ``faults.disable()`` restores the inert default; tests use the
:func:`active` context manager.

**Scoped sites (round 13).**  Fleet chaos needs to target ONE replica
out of N identical engines: every engine-side site call carries an
optional ``scope`` (the daemon's fleet layer stamps each replica's
engine with ``fault_scope="replica<i>"``), and a rule whose site is
written ``site@scope`` — e.g. ``paged.step@replica1`` — matches hits
of that site from that scope only, counted on the scope's OWN
deterministic hit counter.  Bare-site rules keep their pre-round-13
meaning (the global hit count across all scopes), so existing
schedules are unchanged::

    faults.configure([
        {"site": "paged.tick@replica1", "kind": "raise", "at": 40},
        {"site": "paged.drain@replica2", "kind": "slow_ms", "at": 30,
         "count": 40, "arg": 120.0},
    ])

For the wedged-socket-CLIENT case the daemon cannot inject (the client
is another process), :func:`open_wedged_client` opens a connection
that sends a partial frame and then stalls forever — chaos tests point
it at a live daemon to prove handler slots are reclaimed on deadline.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

KINDS = ("raise", "nan_tokens", "corrupt_table", "slow_ms", "kill",
         "preempt")


class InjectedFault(RuntimeError):
    """A deterministically injected fault (kind ``raise``)."""


@dataclass
class _Rule:
    site: str
    kind: str
    at: int = 1            # 1-based site hit index at which firing starts
    count: int = 1         # consecutive hits the rule fires for
    arg: float = 0.0       # kind parameter (slow_ms: milliseconds)
    fired: int = field(default=0, compare=False)

    def matches(self, hit: int) -> bool:
        return self.at <= hit < self.at + self.count


class FaultInjector:
    """Schedule-driven injector; one process-global instance
    (:data:`INJECTOR`) with its enabled state mirrored in the
    module-level :data:`ACTIVE` flag the hot-path guards read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []
        self._hits: Dict[str, int] = {}
        self.rng = random.Random(0)
        self.enabled = False

    def configure(self, schedule, seed: int = 0) -> None:
        rules = []
        for spec in schedule:
            r = _Rule(site=str(spec["site"]), kind=str(spec["kind"]),
                      at=int(spec.get("at", 1)),
                      count=int(spec.get("count", 1)),
                      arg=float(spec.get("arg", 0.0)))
            if r.kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {r.kind!r}; expected one of {KINDS}")
            if r.at < 1 or r.count < 1:
                raise ValueError(
                    f"rule {spec}: 'at' and 'count' must be >= 1")
            rules.append(r)
        with self._lock:
            self._rules = rules
            self._hits = {}
            self.rng = random.Random(seed)
            self.enabled = True
        _set_active(True)

    def disable(self) -> None:
        with self._lock:
            self._rules = []
            self._hits = {}
            self.enabled = False
        _set_active(False)

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def describe(self) -> Dict:
        """Serializable snapshot of the armed state — the flight
        recorder (tpulab_torch/obs/flightrec.py) persists this into every
        post-mortem bundle so a chaos failure records WHICH schedule
        was active and how far each site had counted."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "rules": [
                    {"site": r.site, "kind": r.kind, "at": r.at,
                     "count": r.count, "arg": r.arg, "fired": r.fired}
                    for r in self._rules],
                "hits": dict(self._hits),
            }

    def fired(self) -> Dict[str, int]:
        """{site: rules-fired count} — chaos tests assert the schedule
        actually executed (a test whose fault never fired proves
        nothing)."""
        with self._lock:
            out: Dict[str, int] = {}
            for r in self._rules:
                if r.fired:
                    out[r.site] = out.get(r.site, 0) + r.fired
            return out

    def fire(self, site: str,
             scope: Optional[str] = None) -> Optional[_Rule]:
        """Count one hit of ``site``; apply the matching rule if any.

        ``raise`` raises, ``slow_ms`` sleeps, right here; the
        state-corrupting kinds (``nan_tokens``, ``corrupt_table``) are
        returned for the SITE to apply — only the site knows which
        array to damage.  At most one rule fires per hit (first match
        in schedule order).

        ``scope`` (e.g. a fleet replica's ``"replica1"``) additionally
        counts the hit on the scoped counter ``site@scope``; a rule
        written against the scoped name matches that counter only —
        the per-replica determinism fleet chaos schedules need (each
        replica's stepper hits its own sites in its own order, while
        the bare-site interleaving across replicas is scheduling-
        dependent)."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            scoped = None
            scoped_hit = 0
            if scope is not None:
                scoped = f"{site}@{scope}"
                scoped_hit = self._hits.get(scoped, 0) + 1
                self._hits[scoped] = scoped_hit
            rule = next(
                (r for r in self._rules
                 if (r.site == site and r.matches(hit))
                 or (scoped is not None and r.site == scoped
                     and r.matches(scoped_hit))), None)
            if rule is not None:
                rule.fired += 1
        if rule is None:
            return None
        if rule.kind == "raise":
            raise InjectedFault(
                f"injected fault at {site} (hit {hit})")
        if rule.kind == "slow_ms":
            time.sleep(rule.arg / 1e3)
            return rule
        if rule.kind == "kill":
            # instant process death: os._exit skips every finally,
            # atexit hook, and flush — the closest in-process stand-in
            # for SIGKILL/OOM/preemption, which is exactly what the
            # write-ahead journal (tpulab_torch/durability.py) must survive.
            # ``arg`` is the exit status (default 1).  Subprocess-based
            # tests only: firing this in-process kills the test runner.
            import os

            os._exit(int(rule.arg) if rule.arg else 1)
        return rule


#: process-global injector; ``ACTIVE`` mirrors its enabled state so hot
#: paths pay one global read when fault injection is off (the default)
INJECTOR = FaultInjector()
ACTIVE = False


def _set_active(v: bool) -> None:
    global ACTIVE
    ACTIVE = v


def configure(schedule, seed: int = 0) -> None:
    INJECTOR.configure(schedule, seed)


def disable() -> None:
    INJECTOR.disable()


def describe() -> Dict:
    """Module-level :meth:`FaultInjector.describe` (post-mortem use)."""
    return INJECTOR.describe()


def fire(site: str, scope: Optional[str] = None) -> Optional[_Rule]:
    """Module-level site entry point.  Callers guard with
    ``if faults.ACTIVE:`` so the disabled hot path never enters.
    ``scope`` opts the hit into the per-replica ``site@scope``
    counters fleet chaos schedules target (see :class:`FaultInjector`
    — bare-site rules are unaffected)."""
    if not ACTIVE:
        return None
    return INJECTOR.fire(site, scope)


def configure_from_env(var: str = "TPULAB_FAULTS") -> bool:
    """Arm the injector from an environment variable — the hook that
    lets chaos runs drive a REAL daemon subprocess (the in-process
    ``configure`` cannot reach across a fork/exec).  The value is JSON:
    either a bare schedule list, or ``{"schedule": [...], "seed": N}``.
    Returns True when a schedule was armed.  Called by
    ``tpulab_torch.daemon.main`` at startup; absent/empty means the injector
    stays inert (the production default)."""
    import json
    import os

    spec = os.environ.get(var)
    if not spec:
        return False
    data = json.loads(spec)
    if isinstance(data, dict):
        configure(data["schedule"], int(data.get("seed", 0)))
    else:
        configure(data)
    return True


@contextlib.contextmanager
def active(schedule, seed: int = 0):
    """Context manager for tests: configure, run, always disable."""
    configure(schedule, seed)
    try:
        yield INJECTOR
    finally:
        disable()


def open_wedged_client(socket_path: str):
    """Connect to a daemon socket and send HALF a header-length prefix,
    then go silent — the canonical wedged client.  Returns the open
    socket (caller closes); the daemon must reclaim the handler slot on
    its frame deadline without stalling other clients."""
    import socket as _socket

    s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    s.connect(socket_path)
    s.sendall(b"\x08\x00")  # 2 of the 4 length-prefix bytes, then nothing
    return s
