"""tpulab_torch.autoscale and the elastic fleet, held against tpulab.

The same seeded ``Signals`` sequence drives each package's
``AutoscalePolicy`` and the same pressure sequence each package's
``BrownoutLadder``: every target, overload/underload verdict, transition
and snapshot must be equal, and the validation errors read alike.  On the
port's fleet (the CPU, the shared ``trained_small`` model): scaling in a
loaded replica migrates its greedy stream bit-equal to tpulab's
``generate``; the last serving replica is never retired; ties retire the
highest index; a ``replica.preempt`` notice drains into the peer and the
next scale-out revives the slot, or, with no peer, parks the request
until the revival replays it; an armed fleet's status carries its
``autoscale`` and ``brownout`` blocks; the ladder's token cap bounds an
admission; and the sampler-driven control loop (``_autoscale_tick``)
scales a loaded one-replica fleet out to two and back in, with 0 sheds
and the streams unchanged.  Bad bounds die at startup with tpulab's
argparse errors.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

import tpulab.daemon as jd
from tpulab import autoscale as jauto
from tpulab.models import labformer as jlf
from tpulab.models.generate import generate as jgenerate

import tpulab_torch.daemon as td
from tpulab_torch import autoscale as tauto
from tpulab_torch import faults as tfaults
from tpulab_torch.models import labformer as tlf
from tpulab_torch.models.paged import PagedEngine

torch.set_num_threads(2)


def _signals(mod, rng):
    return mod.Signals(
        active_replicas=rng.randint(1, 4),
        load_per_replica=rng.choice((0.0, 0.5, 1.0, 2.5, 4.0, 9.0)),
        queue_wait_p99_s=rng.choice((None, 0.0, 0.2, 0.3, 0.5, 2.0)),
        shed_rate=rng.choice((0.0, 0.0, 0.0, 1.5)),
        alerts_firing=rng.choice((0, 0, 0, 1)),
        latency_p99_s=rng.choice((None, 0.1, 0.3, 0.9)))


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {"latency_high_s": 0.5}),
    (2, {"out_after": 1, "in_after": 1, "out_cooldown_s": 0.0, "in_cooldown_s": 0.0}),
    (3, {"load_high": 2.0, "load_low": 0.5, "queue_wait_high_s": 0.25})])
def test_policy_decisions_equal(seed, kw):
    pols = (jauto.AutoscalePolicy(1, 4, **kw), tauto.AutoscalePolicy(1, 4, **kw))
    rngs = (random.Random(seed), random.Random(seed))
    moved = set()
    for i in range(300):
        now = i * 0.7
        sigs = [_signals(m, r) for m, r in zip((jauto, tauto), rngs)]
        rows = [(p.overloaded(s), p.underloaded(s), p.observe(now, s), p.snapshot())
                for p, s in zip(pols, sigs)]
        assert rows[0] == rows[1], i
        moved.add(rows[1][2])
    assert len(moved) > 1  # the sequence does move the target


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {"engage_after": 1, "release_after": 1, "step_cooldown_s": 0.0,
                  "token_cap": 5, "deadline_slack": 0.25})])
def test_ladder_decisions_equal(seed, kw):
    ladders = (jauto.BrownoutLadder(**kw), tauto.BrownoutLadder(**kw))
    rng = random.Random(seed)
    levels = set()
    for i in range(300):
        pressure = rng.random() < (0.8 if (i // 40) % 2 == 0 else 0.1)
        rows = []
        for lad in ladders:
            tr = lad.observe(i * 0.6, pressure)
            rows.append((tr, lad.level, lad.hedging_disabled, lad.spec_disabled,
                         lad.cap_steps(100), lad.tighten_deadline_ms(400.0),
                         lad.tighten_deadline_ms(None), lad.snapshot()))
        assert rows[0] == rows[1], i
        levels.add(rows[1][1])
    assert levels == set(range(len(tauto.LADDER) + 1))
    assert tauto.LADDER == jauto.LADDER


@pytest.mark.parametrize("args,kw", [
    ((0, 2), {}), ((3, 2), {}), ((1, 2), {"load_low": 5.0, "load_high": 4.0}),
    ((1, 2), {"out_after": 0}), ((1, 2), {"latency_high_s": 0.0})])
def test_policy_validation_equal(args, kw):
    msgs = []
    for mod in (tauto, jauto):
        with pytest.raises(ValueError) as e:
            mod.AutoscalePolicy(*args, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for bad in ({"engage_after": 0}, {"token_cap": 0}, {"deadline_slack": 0.0}):
        msgs = []
        for mod in (tauto, jauto):
            with pytest.raises(ValueError) as e:
                mod.BrownoutLadder(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------------------ the fleet

@pytest.fixture(scope="module")
def small(trained_small, trained_small_cfg):
    return trained_small, tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg)), \
        trained_small_cfg


@pytest.fixture(autouse=True)
def _faults_off():
    yield
    tfaults.disable()


def _fleet(small, n):
    params, cfg, _ = small
    return td._make_fleet(lambda: (PagedEngine(params, cfg, slots=2, n_blocks=32, block_size=8,
                                               max_seq=64, device="cpu"), None), n)


def _prompt(p):
    return (np.arange(p) % 7).astype(np.int32)


def _want(small, p, steps):
    params, _, jcfg = small
    return np.asarray(jgenerate(params, _prompt(p)[None, :], jcfg, steps=steps,
                                temperature=0.0)[0])


def _no_leaks(eng):
    cached = {b for blocks in eng.prefix_cache.values() for b in blocks}
    assert len(eng.free) + len(cached) == eng.n_usable_blocks
    assert len(set(eng.free)) == len(eng.free)


def _wait_healthy(replica, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        row = td._FLEET_SERVICE.replica_status(replica)
        if row["health"] == "healthy" and not row["retired"]:
            return row
        time.sleep(0.02)
    raise AssertionError(f"replica{replica.index} never came healthy")


def test_scale_in_under_load_migrates_bit_equal(small):
    svc = td._FLEET_SERVICE
    fleet = _fleet(small, 2)
    s0, o0 = td._C_SCALE_INS.value, td._C_SCALE_OUTS.value
    hold = {}
    t = threading.Thread(target=lambda: hold.setdefault(
        "out", svc.generate(fleet, _prompt(4), 24)))
    t.start()
    victim = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and victim is None:
        for r in fleet.replicas:
            with r.cond:
                if r.engine is not None and any(a is not None for a in r.engine.active):
                    victim = r.index
                    break
        time.sleep(0.005)
    assert victim is not None
    assert fleet.retire_replica(index=victim) == victim
    assert td._C_SCALE_INS.value == s0 + 1
    t.join(timeout=60)
    assert np.array_equal(np.asarray(hold["out"]), _want(small, 4, 24))
    st = svc.fleet_status(fleet)
    assert st["active"] == 1 and st["replica"][victim]["retired"]
    assert st["replica"][victim]["health"] == "retired"
    survivor = fleet.replicas[1 - victim]
    with survivor.cond:
        _no_leaks(survivor.engine)
    assert fleet.add_replica() == victim
    assert td._C_SCALE_OUTS.value == o0 + 1
    assert _wait_healthy(fleet.replicas[victim])["generation"] >= 1
    assert len(svc.generate(fleet, _prompt(4), 4)) == 4


def test_scale_in_floor_and_victim_choice(small):
    svc = td._FLEET_SERVICE
    solo = _fleet(small, 1)
    assert solo.retire_replica() is None and solo.retire_replica(index=0) is None
    assert len(svc.generate(solo, _prompt(4), 4)) == 4
    pair = _fleet(small, 2)
    svc.generate(pair, _prompt(4), 2)
    assert pair.retire_replica() == 1  # ties retire the highest index
    with pair.cv:
        assert [r.index for r in pair.replicas if not r.retired] == [0]


def test_preempt_drains_and_scale_out_revives(small):
    svc = td._FLEET_SERVICE
    fleet = _fleet(small, 2)
    p0 = td._C_SPOT_PREEMPTIONS.value
    with tfaults.active([{"site": "replica.preempt@replica0", "kind": "preempt", "at": 4,
                          "arg": 5000.0}]) as inj:
        out = svc.generate(fleet, _prompt(4), 16)
        assert inj.fired() == {"replica.preempt@replica0": 1}
    assert np.array_equal(np.asarray(out), _want(small, 4, 16))
    assert td._C_SPOT_PREEMPTIONS.value == p0 + 1
    st = svc.fleet_status(fleet)
    assert st["active"] == 1 and st["replica"][0]["retired"]
    assert fleet.add_replica() == 0
    _wait_healthy(fleet.replicas[0])


def test_preempt_without_peer_parks_until_revival(small):
    svc = td._FLEET_SERVICE
    fleet = _fleet(small, 1)
    hold = {}
    with tfaults.active([{"site": "replica.preempt@replica0", "kind": "preempt", "at": 4,
                          "arg": 500.0}]):
        t = threading.Thread(target=lambda: hold.setdefault(
            "out", svc.generate(fleet, _prompt(4), 12)))
        t.start()
        deadline = time.monotonic() + 60
        parked = None
        while time.monotonic() < deadline:
            with fleet.cv:
                if fleet.replicas[0].retired:
                    parked = len(fleet.replicas[0].parked)
                    break
            time.sleep(0.01)
    assert parked == 1
    assert fleet.add_replica() == 0
    t.join(timeout=120)
    assert np.array_equal(np.asarray(hold["out"]), _want(small, 4, 12))
    _wait_healthy(fleet.replicas[0])
    with fleet.replicas[0].cond:
        _no_leaks(fleet.replicas[0].engine)


def test_fleet_status_elastic_blocks_match_tpulab(small):
    fleet = _fleet(small, 2)
    st = td._FLEET_SERVICE.fleet_status(fleet)
    assert "autoscale" not in st and "brownout" not in st
    fleet.autoscaler = tauto.AutoscalePolicy(1, 3)
    fleet.brownout = tauto.BrownoutLadder()
    st = td._FLEET_SERVICE.fleet_status(fleet)
    assert st["autoscale"] == jauto.AutoscalePolicy(1, 3).snapshot()
    assert st["brownout"] == jauto.BrownoutLadder().snapshot()


def test_brownout_token_cap_bounds_admission(small, monkeypatch):
    fleet = _fleet(small, 1)
    fleet.brownout = tauto.BrownoutLadder(engage_after=1, release_after=1,
                                          step_cooldown_s=0.0, token_cap=6)
    monkeypatch.setattr(td, "BACKEND", "cpu")
    monkeypatch.setattr(td, "_FLEETS", {td._fleet_key({"prefill_chunk": 0}): (None, fleet)})
    for i in range(3):
        fleet.brownout.observe(float(i), True)
    out = td._handle_generate({"config": {"steps": 20, "prefill_chunk": 0}}, b"hi")
    assert len(out) == 6
    for i in range(3, 6):
        fleet.brownout.observe(float(i), False)
    assert fleet.brownout.level == 0
    out = td._handle_generate({"config": {"steps": 20, "prefill_chunk": 0}}, b"hi")
    assert len(out) == 20


def test_control_loop_scales_out_then_in(small, monkeypatch):
    """The sampler tick's control loop on real load: eight queued
    requests on one 2-slot replica are overload (load 8 >= 4), the
    target rises to 2 and a reconcile thread adds a replica; the idle
    fleet is underload and scales back in.  0 sheds, streams equal."""
    fleet = _fleet(small, 1)
    fleet.autoscaler = tauto.AutoscalePolicy(1, 2, out_after=1, in_after=1,
                                             out_cooldown_s=0.0, in_cooldown_s=0.0)
    fleet.brownout = tauto.BrownoutLadder()
    monkeypatch.setattr(td, "_FLEETS", {("elastic",): (None, fleet)})
    shed0, out0, in0 = td._C_SHED.value, td._C_SCALE_OUTS.value, td._C_SCALE_INS.value
    results = [None] * 8

    def one(i):
        results[i] = td._FLEET_SERVICE.generate(fleet, _prompt(5 + i % 3), 24)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and td._C_SCALE_OUTS.value == out0:
        td._autoscale_tick()
        time.sleep(0.02)
    assert td._C_SCALE_OUTS.value == out0 + 1
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and td._C_SCALE_INS.value == in0:
        with fleet.cv:
            busy = fleet.scaling
        if not busy:
            td._autoscale_tick()
        time.sleep(0.02)
    assert td._C_SCALE_INS.value == in0 + 1 and td._C_SHED.value == shed0
    with fleet.cv:
        assert sum(1 for r in fleet.replicas if not r.retired) == 1
    # the ladder engages whenever the cold build spans its engage streak,
    # which depends on the host's speed; the idle fleet is calm, so tick
    # until it has released every rung it climbed
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and fleet.brownout.level:
        td._autoscale_tick()
        time.sleep(0.02)
    assert fleet.brownout.level == 0
    assert fleet.brownout.engages == fleet.brownout.releases
    assert td._C_SCALE_INS.value == in0 + 1
    for i, out in enumerate(results):
        assert np.array_equal(np.asarray(out), _want(small, 5 + i % 3, 24)), i
    assert td._obs.REGISTRY.get("fleet_target_replicas").value == 1.0


@pytest.mark.parametrize("extra,needle", [
    (["--autoscale-max", "-1"], "--autoscale-max"),
    (["--autoscale-min", "0", "--autoscale-max", "2"], "--autoscale-min"),
    (["--autoscale-min", "3", "--autoscale-max", "2"], "--autoscale-min"),
    (["--replicas", "5", "--autoscale-max", "3"], "--replicas"),
    (["--autoscale-max", "2", "--metrics-interval", "0"], "sampler")])
def test_daemon_validates_autoscale_bounds(extra, needle, tmp_path, capsys):
    errs = []
    for mod in (td, jd):
        with pytest.raises(SystemExit) as e:
            mod.main(["--socket", str(tmp_path / "x.sock"), *extra])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert needle in err
        errs.append(err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errs[0] == errs[1]
