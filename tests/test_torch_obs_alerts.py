"""tpulab_torch.obs.alerts held against tpulab.obs.alerts on the CPU.

The same seeded metric writes are sampled into each package's history
ring at the same explicit times, and each package's ``AlertManager``
(the shipped catalog plus a replica-stall rule and every rule kind)
evaluates them at the same times: the transition lists and the state
tables (``snapshot``) must be equal pass for pass, burn rates and
threshold aggregates equal on the windows both rings hold.  The two
catalogs are the same rules.  On the daemon side both daemons' ``alerts``
requests answer the same keys and states; a replica's degradation alert
drives it to SUSPECT through ``ReplicaHealth.note_alert`` and releases
it on resolution; and a ``slow_ms`` fault on replica 1 fires its
windowed stall rule before any crash, steers placement off it, and
resolves once the fault is gone, the streams equal to a fault-free run.
A page fire records a flight-recorder bundle whose alerts section holds
the firing set.
"""

import json
import random
import threading
import time

import numpy as np
import pytest
import torch

import tpulab.daemon as jd
from tpulab.models import labformer as jlf
from tpulab.models.generate import generate as jgenerate
from tpulab.obs import alerts as jA
from tpulab.obs import history as jH
from tpulab.obs import registry as jreg

import tpulab_torch.daemon as td
from tpulab_torch import faults as tfaults
from tpulab_torch import router as trouter
from tpulab_torch.models import labformer as tlf
from tpulab_torch.models.paged import PagedEngine
from tpulab_torch.obs import alerts as tA
from tpulab_torch.obs import flightrec as tfr
from tpulab_torch.obs import history as tH
from tpulab_torch.obs import registry as treg

torch.set_num_threads(2)

QW_BUCKETS = (0.01, 0.05, 0.25, 1.0, 4.0)


def _catalog(A):
    rules = A.default_rules()
    rules += [A.ReplicaStallRule(0, fleet_id=7, window_s=4.0, for_s=1.0, keep_firing_s=2.0),
              A.ThresholdRule("qw_p99", "queue_wait_seconds", ">", 0.2, agg="p99",
                              window_s=5.0, for_s=1.0, keep_firing_s=1.0),
              A.ThresholdRule("tok_rate", "engine_tokens_out", "<", 5.0, agg="rate",
                              window_s=3.0),
              A.AbsenceRule("heartbeat_stale", "heartbeat", stale_s=4.0),
              A.SamplerStaleRule("stale", max_age_s=3.0)]
    return A.AlertManager(rules)


def _scenario(A, H, reg_mod, seed):
    """A seeded 90-tick run: load spikes, slow replica ticks, a stalled
    heartbeat; returns the transitions and snapshots of every pass."""
    rng = random.Random(seed)
    reg = reg_mod.Registry()
    qw = reg.histogram("queue_wait_seconds", "qw", buckets=QW_BUCKETS)
    ttft = reg.histogram("ttft_seconds", "ttft")
    done = reg.counter("engine_requests_done", "done")
    shed = reg.counter("daemon_shed_requests", "shed")
    toks = reg.counter("engine_tokens_out", "toks")
    ticks = reg.counter("fleet7_replica0_ticks", "ticks")
    slow = reg.counter("fleet7_replica0_slow_ticks", "slow")
    beat = reg.counter("heartbeat", "beat")
    used = reg.gauge("engine_blocks_used", "used")
    total = reg.gauge("engine_blocks_total", "total")
    total.set(100)
    ring = H.MetricsHistory(256)
    mgr = _catalog(A)
    trail = []
    for step in range(90):
        t = step * 0.5
        hot = 20 <= step < 45 or 60 <= step < 70
        for _ in range(rng.randint(1, 5)):
            qw.observe(rng.uniform(0.3, 3.0) if hot else rng.uniform(0.0, 0.04))
            ttft.observe(rng.uniform(0.6, 2.0) if hot else rng.uniform(0.01, 0.2))
            done.inc()
        if hot and rng.random() < 0.5:
            shed.inc(rng.randint(1, 4))
        toks.inc(0 if 30 <= step < 40 else rng.randint(5, 30))
        ticks.inc(4)
        slow.inc(3 if 10 <= step < 25 else 0)
        if step < 50:
            beat.inc()
        used.set(97 if 50 <= step < 60 else rng.randint(10, 60))
        if step % 7 != 3:  # the sampler misses some ticks
            ring.sample(reg, now=t)
        trail.append((mgr.evaluate(ring, now=t + 0.1), mgr.snapshot(now=t + 0.1)))
    return trail


@pytest.mark.parametrize("seed", range(3))
def test_same_samples_same_transitions(seed):
    jtrail = _scenario(jA, jH, jreg, seed)
    ttrail = _scenario(tA, tH, treg, seed)
    assert any(tr for tr, _ in ttrail)  # the scenario does move rules
    fired = {x["rule"] for tr, _ in ttrail for x in tr if x["to"] == tA.FIRING}
    assert {"fleet7_replica0_degraded", "qw_p99", "heartbeat_stale"} <= fired
    for i, ((jt, js), (tt, ts)) in enumerate(zip(jtrail, ttrail)):
        assert tt == jt, i
        # the recompile tripwire's description names the port's run-time
        # builds where tpulab's names XLA compiles; every other field is equal
        for snap in (js, ts):
            for row in snap["alerts"]:
                row.pop("description")
        assert ts == js, i


def test_catalogs_equal():
    """The same rules, severities, timings and descriptions (the recompile
    tripwire's names the port's run-time builds, not XLA compiles)."""
    def rows(A):
        return [(type(r).__name__, r.name, r.severity, r.for_s, r.keep_firing_s,
                 r.description) for r in A.default_rules()]

    assert [r[:5] for r in rows(tA)] == [r[:5] for r in rows(jA)]
    assert [r for r in rows(tA) if r[1] != "recompile_tripwire"] == \
        [r for r in rows(jA) if r[1] != "recompile_tripwire"]
    assert tA.OK == jA.OK and tA.FIRING == jA.FIRING and tA.RESOLVED == jA.RESOLVED


def _burn_hist(H, reg_mod, bad_long, good_long, bad_short, good_short, budget=0.1):
    reg = reg_mod.Registry()
    h = reg.histogram("ttft_seconds", buckets=(budget, 2 * budget, 8 * budget))
    hist = H.MetricsHistory(64)
    hist.sample(reg, now=0.0)
    for _ in range(good_long):
        h.observe(budget / 2)
    for _ in range(bad_long):
        h.observe(budget * 4)
    hist.sample(reg, now=45.0)
    for _ in range(good_short):
        h.observe(budget / 2)
    for _ in range(bad_short):
        h.observe(budget * 4)
    hist.sample(reg, now=60.0)
    return hist


@pytest.mark.parametrize("counts", [(5, 40, 5, 10), (30, 0, 0, 20), (10, 10, 10, 0),
                                    (2, 8, 2, 8), (0, 0, 0, 0)])
def test_burn_rates_equal(counts):
    out = []
    for A, H, reg_mod in ((jA, jH, jreg), (tA, tH, treg)):
        hist = _burn_hist(H, reg_mod, *counts)
        r = A.BurnRateRule("b", objective=0.9, metric="ttft_seconds", budget_s=0.1,
                           long_s=60, short_s=15, burn=2.0, for_s=0)
        ctx = A._Ctx(hist, 60.0)
        out.append((r.burn_rates(ctx), r.probe(ctx)))
    assert out[0] == out[1]


def test_rule_validation_equal():
    for bad in (dict(metric="m", budget_s=1, bad_metric="b", good_metric="g"),
                dict(metric="m", budget_s=1, long_s=10, short_s=10),
                dict(metric="m", budget_s=1, objective=1.0)):
        msgs = []
        for A in (tA, jA):
            with pytest.raises(ValueError) as e:
                A.BurnRateRule("x", **bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_replica_health_note_alert_demotes_holds_releases():
    h = trouter.ReplicaHealth(slow_tick_s=0.1, suspect_after=3, recover_after=2)
    h.note_alert(True)
    assert h.state == trouter.SUSPECT and h.suspects == 1
    for _ in range(3):
        h.note_tick(0.01)
    assert h.state == trouter.SUSPECT
    h.note_alert(False)
    h.note_tick(0.01)
    assert h.state == trouter.SUSPECT
    h.note_tick(0.01)
    assert h.state == trouter.HEALTHY


class _FlagRule:
    """A rule driven by an external flag, for both packages."""

    @staticmethod
    def make(A, name):
        class Flag(A.Rule):
            active = False

            def probe(self, ctx):
                return self.active, 1.0 if self.active else 0.0, "flag"

        return Flag(name, for_s=0)


def test_alerts_request_same_keys_and_states():
    rows = []
    for mod, A in ((td, tA), (jd, jA)):
        r = _FlagRule.make(A, "wire_probe")
        mod._obs.ALERTS.add(r, replace=True)
        try:
            r.active = True
            snap = json.loads(mod.handle_request({"lab": "alerts"}, b""))
            row = [x for x in snap["alerts"] if x["rule"] == "wire_probe"][0]
            r.active = False
            snap2 = json.loads(mod.handle_request(
                {"lab": "alerts", "config": {"no_evaluate": True}}, b""))
            row2 = [x for x in snap2["alerts"] if x["rule"] == "wire_probe"][0]
            rows.append((set(snap), set(row), row["state"], row2["state"]))
        finally:
            mod._obs.ALERTS.remove("wire_probe")
    assert rows[0] == rows[1]
    assert rows[0][2] == rows[0][3] == tA.FIRING


def test_page_fire_bundle_carries_the_firing_set(tmp_path):
    tfr.configure_flightrec(tmp_path / "pm")
    try:
        m = tA.AlertManager([], page_postmortems=True)
        r = _FlagRule.make(tA, "page_probe")
        r.severity = "page"
        m.add(r)
        tA.ALERTS.add(r, replace=True)
        r.active = True
        tA.ALERTS.evaluate(tH.MetricsHistory(4), now=1.0)
        m.evaluate(tH.MetricsHistory(4), now=1.0)
        bundle = tfr.latest_postmortem()
        assert bundle["reason"] == "alert_page:page_probe"
        assert bundle["extra"]["alert"]["rule"] == "page_probe"
        assert any(a["rule"] == "page_probe" for a in bundle["alerts"])
    finally:
        tA.ALERTS.remove("page_probe")
        tfr.configure_flightrec(None)


# ------------------------------------------------------------ the fleet

@pytest.fixture(scope="module")
def small(trained_small, trained_small_cfg):
    return trained_small, tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg)), \
        trained_small_cfg


def _fleet(small, n=2):
    params, cfg, _ = small
    return td._make_fleet(lambda: (PagedEngine(params, cfg, slots=2, n_blocks=32, block_size=8,
                                               max_seq=64, device="cpu"), None), n)


def _quiesce(fleet, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        busy = False
        for r in fleet.replicas:
            with r.cond:
                eng = r.engine
                if (r.dead or r.stepper_alive or eng.pending or eng.inflight_depth
                        or any(a is not None for a in eng.active)):
                    busy = True
            with fleet.cv:
                if r.health.state in (trouter.QUARANTINED, trouter.REBUILDING):
                    busy = True
        if not busy:
            return
        time.sleep(0.02)
    raise AssertionError("fleet never quiesced")


def test_ensure_replica_rules_and_apply(small, monkeypatch):
    fleet = _fleet(small)
    monkeypatch.setitem(td._FLEETS, ("alerts-glue",), (None, fleet))
    f = fleet.fid
    names = (f"fleet{f}_replica0_degraded", f"fleet{f}_replica1_degraded")
    try:
        td._ensure_replica_rules()
        assert set(names) <= {r.name for r in td._obs.ALERTS.rules}
        st = td._obs.ALERTS.get_state(names[1])
        st.state = tA.FIRING
        td._apply_fleet_alerts()
        with fleet.cv:
            assert fleet.replicas[1].health.state == trouter.SUSPECT
            assert fleet.replicas[0].health.state == trouter.HEALTHY
        st.state = tA.RESOLVED
        td._apply_fleet_alerts()
        with fleet.cv:
            assert not fleet.replicas[1].health.alert_firing
    finally:
        for n in names:
            td._obs.ALERTS.remove(n)


def test_slow_replica_fires_steers_and_resolves(small, monkeypatch):
    """A ``slow_ms`` fault on replica 1 fires its windowed stall rule
    (SUSPECT, placement steers off it) before any crash; once the fault
    is gone the rule resolves and the replica takes placement again.
    Streams equal a fault-free run and tpulab's generate."""
    params, cfg, jcfg = small
    fleet = _fleet(small)
    monkeypatch.setitem(td._FLEETS, ("alerts-slow",), (None, fleet))
    f = fleet.fid
    rule1 = f"fleet{f}_replica1_degraded"
    for i in (0, 1):
        td._obs.ALERTS.add(tA.ReplicaStallRule(i, fleet_id=f, window_s=2.0, min_ticks=2,
                                               slow_frac=0.5, for_s=0, keep_firing_s=0.3),
                           replace=True)
    td._obs.HISTORY.clear()
    svc = td._FLEET_SERVICE
    pa = (np.arange(5) % 7).astype(np.int32)
    pb = (np.arange(6) % 7).astype(np.int32)
    tfaults.configure([{"site": "paged.tick@replica1", "kind": "slow_ms", "at": 1,
                        "count": 8, "arg": 300.0}])
    results = {}
    try:
        def run(name, prompt, steps):
            results[name] = svc.generate(fleet, prompt, steps)

        ta = threading.Thread(target=run, args=("a", pa, 30))
        ta.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with fleet.replicas[0].cond:
                if any(x is not None for x in fleet.replicas[0].engine.active):
                    break
            time.sleep(0.005)
        tb = threading.Thread(target=run, args=("b", pb, 20))
        tb.start()
        fired = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            td._obs.HISTORY.sample()
            td._obs.ALERTS.evaluate(td._obs.HISTORY)
            td._apply_fleet_alerts()
            if td._obs.ALERTS.get_state(rule1).state == tA.FIRING:
                with fleet.cv:
                    fired = (fleet.replicas[1].health.crashes,
                             fleet.replicas[1].health.state)
                break
            time.sleep(0.1)
        assert fired == (0, trouter.SUSPECT)
        placed = svc._place(fleet, pb)
        assert placed is not None and placed.index == 0
        ta.join(timeout=120)
        tb.join(timeout=120)
        assert not ta.is_alive() and not tb.is_alive()
    finally:
        tfaults.disable()
    for name, prompt, steps in (("a", pa, 30), ("b", pb, 20)):
        want = np.asarray(jgenerate(params, prompt[None, :], jcfg, steps=steps,
                                    temperature=0.0)[0])
        assert np.array_equal(np.asarray(results[name]), want), name
    _quiesce(fleet)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        td._obs.HISTORY.sample()
        td._obs.ALERTS.evaluate(td._obs.HISTORY)
        td._apply_fleet_alerts()
        if td._obs.ALERTS.get_state(rule1).state in (tA.RESOLVED, tA.OK):
            break
        time.sleep(0.1)
    assert td._obs.ALERTS.get_state(rule1).state == tA.RESOLVED
    with fleet.cv:
        assert fleet.replicas[1].health.placeable
        assert not fleet.replicas[1].health.alert_firing
    for i in (0, 1):
        td._obs.ALERTS.remove(f"fleet{f}_replica{i}_degraded")
    td._obs.HISTORY.clear()
