"""Disaggregated prefill/decode pools in tpulab_torch.daemon, held against
tpulab on the CPU.

``_parse_pool_spec`` accepts and refuses the same specs with the same
messages; placement is phase-aware; a pooled fleet (``prefill=1,
decode=1``, radix index and a spill tier) serves greedy and sampled
streams bit-equal to unified serving, each request handed off once with
its KV bytes counted, the decode engine's admission prefetch consuming
the imported blocks, and no block leaked in either pool; the fleet
status carries roles and pools; the pool park frame parses through
``loadgen.SHED_RE``; pools scale independently and keep their floors.

Both daemons in one process (``trained_small``), each with the same
``--pool-spec``, answer the same concurrent requests with equal bytes.
The CPU counterpart of ``tools/goodput_gate.py --spec disagg``: a served
daemon (``serve`` on a thread) answers a burst of streaming clients over
the wire with bytes equal to a unified daemon's, handoffs equal to the
requests, and both pools' blocks all back.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import tpulab.daemon as jd
import tpulab.models.generate as jgen
from tpulab.models import labformer as jlf

import tpulab_torch.daemon as td
import tpulab_torch.models.generate as tgen
from tpulab_torch import autoscale as tauto
from tpulab_torch import client as tclient
from tpulab_torch import faults as tfaults
from tpulab_torch import loadgen as tload
from tpulab_torch import router as trouter
from tpulab_torch.models import labformer as tlf
from tpulab_torch.models.paged import PagedEngine

torch.set_num_threads(2)

POOLS = [("prefill", 1, 1), ("decode", 1, 1)]


@pytest.fixture(scope="module")
def small(trained_small, trained_small_cfg):
    return trained_small, tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))


@pytest.fixture(autouse=True)
def _faults_off():
    yield
    tfaults.disable()


def _fleet(small, n, pools=None):
    params, cfg = small
    return td._make_fleet(
        lambda: (PagedEngine(params, cfg, slots=2, n_blocks=32, block_size=8, max_seq=64,
                             prefix_index="radix", spill_blocks=16, device="cpu"), None),
        n, pools=pools)


def _prompt(p):
    return (np.arange(p) % 7).astype(np.int32)


def _no_leaks(eng):
    cached = set(eng._radix.blocks())
    assert len(eng.free) + len(cached) == eng.n_usable_blocks
    assert len(set(eng.free)) == len(eng.free)
    assert all(eng.block_refs[b] == 0 for b in eng.free)


def _wait_idle(fleet, timeout=30):
    """Until no replica's stepper runs (each read under its own lock)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = False
        for r in fleet.replicas:
            with r.cond:
                alive |= r.stepper_alive
        if not alive:
            return
        time.sleep(0.02)
    raise AssertionError("fleet never went idle")


def _engines(fleet):
    out = []
    for r in fleet.replicas:
        with r.cond:
            if not r.dead:
                out.append((r.role, r.engine))
    return out


@pytest.mark.parametrize("spec", [
    "prefill=1,decode=1", "prefill=1..3, decode=2", "unified=2", "decode=2..4",
    "", "  ", "draft=1", "prefill", "prefill=0", "prefill=3..2", "prefill=1,prefill=2",
    "prefill=x", "prefill=1..y"])
def test_parse_pool_spec_equal(spec):
    got = []
    for mod in (td, jd):
        try:
            got.append(("ok", mod._parse_pool_spec(spec)))
        except ValueError as e:
            got.append(("err", str(e)))
    assert got[0] == got[1]


def test_phase_aware_placement(small):
    views = [trouter.ReplicaView(0, True, False, 0, 0, role=trouter.ROLE_PREFILL),
             trouter.ReplicaView(1, True, False, 0, 0, role=trouter.ROLE_DECODE)]
    assert trouter.choose_replica(views, phase=trouter.ROLE_PREFILL) == 0
    assert trouter.choose_replica(views, phase=trouter.ROLE_DECODE) == 1
    assert trouter.choose_replica(views[:1], phase=trouter.ROLE_DECODE) is None
    assert td._FleetService._entry_phase(_fleet(small, 1)) is None
    pooled = _fleet(small, 0, pools=POOLS)
    assert td._FleetService._entry_phase(pooled) == trouter.ROLE_PREFILL
    with pooled.replicas[0].cond:
        assert pooled.replicas[0].engine.handoff_at_boundary
    with pooled.replicas[1].cond:
        assert not pooled.replicas[1].engine.handoff_at_boundary


@pytest.mark.parametrize("sampled", [False, True])
def test_pooled_bit_equal_to_unified_with_handoff(small, sampled):
    svc = td._FLEET_SERVICE
    kw = {"temperature": 0.8, "seed": 3} if sampled else {}
    want = svc.generate(_fleet(small, 1), _prompt(20), 12, **kw)
    pooled = _fleet(small, 0, pools=POOLS)
    h0, b0 = td._C_HANDOFFS.value, td._C_HANDOFF_BYTES.value
    got = svc.generate(pooled, _prompt(20), 12, **kw)
    assert np.array_equal(np.asarray(want), np.asarray(got))
    assert td._C_HANDOFFS.value == h0 + 1 and td._C_HANDOFF_BYTES.value > b0
    roles = dict(_engines(pooled))
    assert roles["prefill"].counters["requests_done"] == 0
    assert roles["decode"].counters["requests_done"] == 1
    assert roles["decode"].counters["tokens_out"] == 12
    assert roles["decode"].counters["spill_prefetched"] >= 1
    for _, eng in _engines(pooled):
        _no_leaks(eng)


def test_fleet_status_roles_and_pools(small):
    pooled = _fleet(small, 0, pools=[("prefill", 1, 2), ("decode", 1, 1)])
    st = td._FLEET_SERVICE.fleet_status(pooled)
    assert [r["role"] for r in st["replica"]] == ["prefill", "decode"]
    assert st["pools"]["prefill"]["min"] == 1 and st["pools"]["prefill"]["max"] == 2
    assert st["pools"]["prefill"]["autoscale"] == tauto.AutoscalePolicy(1, 2).snapshot()
    assert st["pools"]["decode"]["autoscale"] is None
    assert "pools" not in td._FLEET_SERVICE.fleet_status(_fleet(small, 1))


def test_pool_park_frame_matches_shed_re():
    err = td.PoolRebuildingError(250, trouter.ROLE_PREFILL, "no placeable replica in pool")
    assert str(err) == str(jd.PoolRebuildingError(250, "prefill", "no placeable replica in pool"))
    m = tload.SHED_RE.search(str(err))
    assert m is not None and (m.group(1), m.group(2)) == ("rebuilding", "250")
    assert isinstance(err, td.RebuildingError)


def test_pools_scale_independently(small):
    pooled = _fleet(small, 0, pools=[("prefill", 1, 2), ("decode", 1, 1)])
    svc = td._FLEET_SERVICE

    def count(role):
        with pooled.cv:
            return sum(1 for r in pooled.replicas if not r.retired and r.role == role)

    td._reconcile_fleet(pooled, 2, trouter.ROLE_PREFILL)
    assert (count("prefill"), count("decode")) == (2, 1)
    new = pooled.replicas[-1]
    with new.cond:
        assert new.role == "prefill" and new.engine.handoff_at_boundary
    want = svc.generate(_fleet(small, 1), _prompt(20), 12)
    assert np.array_equal(np.asarray(svc.generate(pooled, _prompt(20), 12)), np.asarray(want))
    assert svc.scale_in(pooled, role="prefill") is not None
    assert count("prefill") == 1
    assert svc.scale_in(pooled, role="prefill") is None
    assert svc.scale_in(pooled, role="decode") is None


def test_handoff_crash_replays_bit_equal(small):
    """A ``daemon.handoff`` fault drops the KV payload: the request
    replays from its prompt through the migration path, charged to the
    replay budget, and its stream is still the unified one."""
    svc = td._FLEET_SERVICE
    want = svc.generate(_fleet(small, 1), _prompt(20), 12)
    pooled = _fleet(small, 0, pools=POOLS)
    with tfaults.active([{"site": "daemon.handoff", "kind": "raise", "at": 1}]) as inj:
        got = svc.generate(pooled, _prompt(20), 12)
        assert inj.fired() == {"daemon.handoff": 1}
    assert np.array_equal(np.asarray(got), np.asarray(want))
    _wait_idle(pooled)
    for _, eng in _engines(pooled):
        _no_leaks(eng)


# ------------------------------------------------------------ the daemons

@pytest.fixture
def daemons(trained_small, trained_small_cfg, monkeypatch):
    tcfg = tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))
    monkeypatch.setattr(jgen, "demo_config", lambda: trained_small_cfg)
    monkeypatch.setattr(jgen, "load_params", lambda cfg, path=None, seed=0: (trained_small, None))
    monkeypatch.setattr(tgen, "demo_config", lambda: tcfg)
    monkeypatch.setattr(tgen, "load_params", lambda cfg, path=None, seed=0: (trained_small, None))
    monkeypatch.setattr(td, "BACKEND", "cpu")
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_SERVE_MAX_SEQ", 128)
        monkeypatch.setattr(mod, "_FLEETS", {})
        monkeypatch.setattr(mod, "PREFIX_INDEX", "radix")
        monkeypatch.setattr(mod, "SPILL_BLOCKS", 32)
    monkeypatch.setattr(jd, "_ENGINES", {})
    yield


def _payloads(n):
    return [bytes(((np.arange(30 + 3 * i) + i) % 7).astype(np.uint8)) for i in range(n)]


def _burst(call, payloads):
    out, errs = [None] * len(payloads), []

    def one(i):
        try:
            out[i] = call(i, payloads[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(payloads))]
    for th in threads:
        th.start()
        time.sleep(0.01)
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errs, errs
    return out


def _pooled_engines(mod):
    with mod._FLEET_SERVICE.lock:
        (fleet,) = [v[1] for v in mod._FLEETS.values()]
    return fleet


def test_both_daemons_pooled_equal(daemons, monkeypatch):
    cfg = {"steps": 10, "prefill_chunk": 0}
    unified = [td.handle_request({"lab": "generate", "config": dict(cfg)}, p)
               for p in _payloads(4)]
    monkeypatch.setattr(td, "_FLEETS", {})
    outs = {}
    for name, mod in (("port", td), ("jax", jd)):
        monkeypatch.setattr(mod, "POOL_SPEC", "prefill=1,decode=1")
        h0 = mod._C_HANDOFFS.value
        outs[name] = _burst(lambda i, p, mod=mod: mod.handle_request(
            {"lab": "generate", "config": dict(cfg)}, p), _payloads(4))
        assert mod._C_HANDOFFS.value == h0 + 4
        fleet = _pooled_engines(mod)
        assert [r.role for r in fleet.replicas] == ["prefill", "decode"]
    assert outs["port"] == outs["jax"] == unified
    fleet = _pooled_engines(td)
    _wait_idle(fleet)
    for _, eng in _engines(fleet):
        _no_leaks(eng)


def test_served_disagg_burst_matches_unified(daemons, monkeypatch, tmp_path):
    """The goodput gate's ``--spec disagg`` on the CPU: the same burst of
    streaming clients over the wire against a unified and a pooled
    daemon."""
    results = {}
    for layout in ("", "prefill=1,decode=1"):
        monkeypatch.setattr(td, "_FLEETS", {})
        monkeypatch.setattr(td, "POOL_SPEC", layout)
        sock = str(tmp_path / f"d{len(layout)}.sock")
        stop = threading.Event()
        th = threading.Thread(target=td.serve, args=(sock,),
                              kwargs={"stop_event": stop}, daemon=True)
        th.start()
        try:
            deadline = time.monotonic() + 30
            while not os.path.exists(sock) and time.monotonic() < deadline:
                time.sleep(0.02)
            h0 = td._C_HANDOFFS.value

            def call(i, p):
                chunks = []
                out = tclient.request(sock, "generate", {"steps": 16, "stream": True,
                                                         "tag": f"d{i}"}, p,
                                      on_chunk=chunks.append)
                assert b"".join(chunks) == out
                return out

            results[layout] = _burst(call, _payloads(6))
            if layout:
                assert td._C_HANDOFFS.value == h0 + 6
                st = json.loads(tclient.request(sock, "fleet", {}))
                assert st["pools"] == {"prefill": {"min": 1, "max": 1, "autoscale": None},
                                       "decode": {"min": 1, "max": 1, "autoscale": None}}
        finally:
            stop.set()
            th.join(timeout=30)
        assert td._SAMPLER is None  # serve stopped its sampler
    assert results["prefill=1,decode=1"] == results[""]
    fleet = _pooled_engines(td)
    _wait_idle(fleet)
    for _, eng in _engines(fleet):
        _no_leaks(eng)
