"""tpulab_torch.faults and tpulab_torch.router held against tpulab's.

The injector: the same schedules over the same site-hit sequences fire
the same rules at the same hits (bare and replica-scoped sites), with the
same ``fired``/``describe`` views, the same kinds and the same errors.
The router: the health state machine walks the same states through any
sequence of ticks, crashes, rebuilds and alerts, and ``choose_replica``
picks the same replica on any set of views (hypothesis-generated),
phase-blind and per pool role.
"""

import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpulab import faults as jfaults
from tpulab import router as jrouter
from tpulab_torch import faults as tfaults
from tpulab_torch import router as trouter

SITES = ("paged.step", "paged.tick", "paged.drain", "daemon.step", "daemon.send",
         "replica.preempt", "daemon.kill", "daemon.handoff")


@pytest.fixture(autouse=True)
def _both_disabled():
    yield
    jfaults.disable()
    tfaults.disable()


def test_kinds_and_sites_equal():
    assert tfaults.KINDS == jfaults.KINDS
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.configure([{"site": "paged.step", "kind": "explode"}])
        with pytest.raises(ValueError, match="must be >= 1"):
            mod.configure([{"site": "paged.step", "kind": "raise", "at": 0}])


def _drive(mod, schedule, hits, seed):
    """Feed one hit sequence through ``mod``'s injector; the outcome per
    hit (None, a rule kind, or "raised") and the final views."""
    mod.configure(schedule, seed=seed)
    outcomes = []
    for site, scope in hits:
        try:
            rule = mod.fire(site, scope)
            outcomes.append(None if rule is None else (rule.kind, rule.at, rule.count))
        except mod.InjectedFault as e:
            outcomes.append(("raised", str(e)))
    desc = mod.describe()
    fired = mod.INJECTOR.fired()
    per_site = {s: mod.INJECTOR.hits(s) for s, _ in hits}
    mod.disable()
    return outcomes, desc, fired, per_site


@pytest.mark.parametrize("seed", range(6))
def test_fired_counts_equal_under_the_same_schedules(seed):
    rng = random.Random(seed)
    scopes = (None, "replica0", "replica1")
    schedule = []
    for _ in range(rng.randint(1, 5)):
        site = rng.choice(SITES[:5])
        if rng.random() < 0.5:
            site = f"{site}@{rng.choice(scopes[1:])}"
        schedule.append({"site": site, "kind": rng.choice(("raise", "nan_tokens",
                                                           "corrupt_table", "preempt")),
                         "at": rng.randint(1, 6), "count": rng.randint(1, 3),
                         "arg": rng.choice((0.0, 2.0))})
    hits = [(rng.choice(SITES[:5]), rng.choice(scopes)) for _ in range(60)]
    assert _drive(tfaults, schedule, hits, seed) == _drive(jfaults, schedule, hits, seed)


def test_scoped_rule_fires_only_on_its_replica():
    schedule = [{"site": "paged.tick@replica1", "kind": "raise", "at": 2}]
    hits = [("paged.tick", "replica0"), ("paged.tick", "replica1"),
            ("paged.tick", "replica0"), ("paged.tick", "replica1"),
            ("paged.tick", "replica1")]
    got = _drive(tfaults, schedule, hits, 0)
    assert got == _drive(jfaults, schedule, hits, 0)
    assert [o is not None for o in got[0]] == [False, False, False, True, False]
    assert got[2] == {"paged.tick@replica1": 1}
    assert got[3] == {"paged.tick": 5}


def test_disabled_injector_never_counts():
    for mod in (tfaults, jfaults):
        assert not mod.ACTIVE and mod.fire("paged.step") is None
        with mod.active([{"site": "paged.step", "kind": "raise", "at": 1}]) as inj:
            assert mod.ACTIVE
            with pytest.raises(mod.InjectedFault):
                mod.fire("paged.step", "replica0")
            assert inj.fired() == {"paged.step": 1}
        assert not mod.ACTIVE and mod.INJECTOR.hits("paged.step") == 0


# ------------------------------------------------------------------ router

EVENTS = ("fast", "slow", "stalled", "crash", "rebuild_start", "rebuilt", "rebuild_failed",
          "retired", "alert_on", "alert_off")


def _apply(h, ev):
    if ev == "fast":
        h.note_tick(0.001)
    elif ev == "slow":
        h.note_tick(10.0)
    elif ev == "stalled":
        h.note_tick(0.001, stalled=True)
    elif ev == "crash":
        h.note_crash()
    elif ev == "rebuild_start":
        h.note_rebuild_start()
    elif ev == "rebuilt":
        h.note_rebuilt()
    elif ev == "rebuild_failed":
        h.note_rebuild_failed()
    elif ev == "retired":
        h.note_retired()
    else:
        h.note_alert(ev == "alert_on")


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(EVENTS), max_size=40))
def test_health_transitions_equal(events):
    th, jh = trouter.ReplicaHealth(), jrouter.ReplicaHealth()
    for ev in events:
        _apply(th, ev)
        _apply(jh, ev)
        assert (th.state, th.placeable, th.suspects, th.crashes) == (
            jh.state, jh.placeable, jh.suspects, jh.crashes)
        assert th.snapshot() == jh.snapshot()


def test_health_walks_every_state():
    h = trouter.ReplicaHealth(suspect_after=2, recover_after=2)
    seen = [h.state]
    for ev in ("slow", "slow", "fast", "fast", "crash", "rebuild_start", "rebuilt",
               "retired"):
        _apply(h, ev)
        seen.append(h.state)
    assert seen == ["healthy", "healthy", "suspect", "suspect", "healthy", "quarantined",
                    "rebuilding", "healthy", "retired"]


_view = st.tuples(st.booleans(), st.booleans(), st.integers(0, 9), st.integers(0, 6),
                  st.sampled_from(trouter.ROLES))


@settings(max_examples=150, deadline=None)
@given(st.lists(_view, max_size=8), st.sampled_from((None,) + trouter.ROLES))
def test_choose_replica_equal(views, phase):
    tv = [trouter.ReplicaView(i, *v[:4], role=v[4]) for i, v in enumerate(views)]
    jv = [jrouter.ReplicaView(i, *v[:4], role=v[4]) for i, v in enumerate(views)]
    assert trouter.choose_replica(tv, phase=phase) == jrouter.choose_replica(jv, phase=phase)
    assert trouter.choose_replica(tv) == jrouter.choose_replica(jv)
    assert trouter.pool_counts([v[4] for v in views]) == jrouter.pool_counts(
        [v[4] for v in views])
