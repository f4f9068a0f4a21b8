"""tpulab_torch.daemon held against tpulab.daemon in one process.

Both daemons' ``handle_request`` serve the same requests on the CPU, the
serving model being the shared sharp-logit small labformer (``demo_config``
and ``load_params`` of each package are pointed at ``trained_small``, so
each daemon's own ``_build_engine`` builds its fleet).  Lab outputs are
byte-equal past the timing line; ``generate`` bytes are equal across
gather/pallas attention, native/int8 KV, streaming (the chunks reassemble
into the terminal bytes), a stop byte, prompt lookup and the int8 draft;
error texts match; deadline shedding answers the parseable
``shed retry_after_ms=`` line.  With two replicas and a crash scoped to
replica 1, every greedy output equals the fault-free output, requests
migrate and no block leaks; drain/undrain and a hedge work.  ``tpulab``'s
eight mesh-knob rejections raise in both daemons with its messages before
any engine is built, and a malformed ``--mesh`` exits 2
(``tests/test_torch_daemon_mesh.py`` serves the mesh itself).

Fleet and engine state is read under the locks the daemon itself takes
(``replica.cond``, ``fleet.cv``).
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import tpulab.daemon as jd
import tpulab.models.generate as jgen
from tpulab.models import labformer as jlf
from tpulab import faults as jfaults
from tpulab.io import protocol as jprotocol
from tpulab.obs import flightrec as jfr

import tpulab_torch.daemon as td
import tpulab_torch.models.generate as tgen
from tpulab_torch import faults as tfaults
from tpulab_torch import loadgen as tload
from tpulab_torch import router as trouter
from tpulab_torch.io.imagefile import load_image, save_image
from tpulab_torch.models import labformer as tlf
from tpulab_torch.obs import flightrec as tfr

torch.set_num_threads(2)

PROMPT = bytes((np.arange(20) % 7).astype(np.uint8))


def _quiesce(mod, timeout=60):
    """Wait until every warm fleet of ``mod`` is idle and healthy."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        busy = False
        with mod._FLEET_SERVICE.lock:
            fleets = [v[1] for v in mod._FLEETS.values()]
        for fleet in fleets:
            for r in fleet.replicas:
                with r.cond:
                    eng = r.engine
                    if eng is not None and (r.dead or r.stepper_alive or eng.pending
                                            or eng.inflight_depth
                                            or any(a is not None for a in eng.active)):
                        busy = True
                with fleet.cv:
                    if r.health.state in ("quarantined", "rebuilding"):
                        busy = True
        if not busy:
            return fleets
        time.sleep(0.02)
    raise AssertionError("fleet never quiesced")


@pytest.fixture
def daemons(trained_small, trained_small_cfg, monkeypatch, tmp_path):
    """Both daemons serving ``trained_small`` on the CPU, fleets reset,
    post-mortem bundles written under ``tmp_path``."""
    tcfg = tlf.cfg_from_dict(jlf.cfg_to_dict(trained_small_cfg))
    monkeypatch.setattr(jgen, "demo_config", lambda: trained_small_cfg)
    monkeypatch.setattr(jgen, "load_params", lambda cfg, path=None, seed=0: (trained_small, None))
    monkeypatch.setattr(tgen, "demo_config", lambda: tcfg)
    monkeypatch.setattr(tgen, "load_params", lambda cfg, path=None, seed=0: (trained_small, None))
    monkeypatch.setattr(td, "BACKEND", "cpu")
    for mod in (jd, td):
        monkeypatch.setattr(mod, "_SERVE_MAX_SEQ", 128)
        monkeypatch.setattr(mod, "_FLEETS", {})
    monkeypatch.setattr(jd, "_ENGINES", {})
    tfr.configure_flightrec(tmp_path / "port_pm")
    jfr.configure_flightrec(tmp_path / "jax_pm")
    # the slow log keeps the process's worst 64 requests: a file run before
    # this one in the same worker (chip_smoke's phase 12 rehearsal) fills it
    # with slower requests than these tests make (C16)
    td._obs.SLOWLOG.clear()
    yield
    for mod in (jd, td):
        _quiesce(mod)
    tfr.configure_flightrec(None)
    jfr.configure_flightrec(None)
    jfaults.disable()
    tfaults.disable()


def _both(header, payload=b""):
    return (td.handle_request(header, payload), jd.handle_request(header, payload))


def _gen(config, payload=PROMPT):
    return {"lab": "generate", "config": config}, payload


# ------------------------------------------------------------------ labs

def test_lab_outputs_byte_equal(tmp_path):
    text = "3\n1.5 -2 1e300\n0.25 4 -1e300\n"
    t, j = _both({"lab": "lab1", "backend": "cpu", "config": {}}, text.encode())
    assert t.split(b"\n", 1)[1] == j.split(b"\n", 1)[1]
    assert t.startswith(b"CPU execution time: <")
    src = load_image("data/lab2/data/rings_16x16.txt")
    outs = {}
    for name, mod in (("port", td), ("jax", jd)):
        inp, out = tmp_path / f"{name}_in.data", tmp_path / f"{name}_out.data"
        save_image(str(inp), src)
        stdout = mod.handle_request({"lab": "lab2", "backend": "cpu", "config": {}},
                                    jprotocol.format_lab2_input(str(inp), str(out)).encode())
        outs[name] = (stdout.split(b"\n", 1)[1], out.read_bytes())
    assert outs["port"] == outs["jax"]


def test_platform_is_the_torch_device(daemons, monkeypatch):
    assert td.handle_request({"lab": "platform"}, b"") == b"cpu"
    assert jd.handle_request({"lab": "platform"}, b"") == b"cpu"
    monkeypatch.setattr(td, "BACKEND", "cuda")
    if not torch.cuda.is_available():  # the card by default, no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.handle_request({"lab": "platform"}, b"")


# ------------------------------------------------------------------ generate

@pytest.mark.parametrize("attn,kv", [("gather", "native"), ("pallas", "native"),
                                     ("gather", "int8"), ("pallas", "int8")])
def test_generate_bytes_equal(daemons, attn, kv):
    base = {"steps": 14, "attn": attn, "kv_dtype": kv}
    t, j = _both(*_gen(base))
    assert t == j and len(t) == 14
    chunks = []
    got = td.handle_request(*_gen({**base, "stream": True}), send_chunk=chunks.append)
    assert got == t and b"".join(chunks) == t and len(chunks) > 1
    stop = int(t[5])
    t2, j2 = _both(*_gen({**base, "stop_byte": stop}))
    assert t2 == j2 and t2.endswith(bytes([stop])) and len(t2) <= 6


def test_generate_speculation_equal(daemons):
    base = {"steps": 16}
    plain, jplain = _both(*_gen(base))
    assert plain == jplain
    for extra in ({"prompt_lookup": True, "lookup_ngram": 2}, {"speculative": True,
                                                               "draft_k": 3}):
        t, j = _both(*_gen({**base, **extra}))
        assert t == j == plain, extra


def test_generate_stats_and_metrics(daemons):
    td.handle_request(*_gen({"steps": 6, "tag": "probe"}))
    st = td.handle_request({"lab": "generate_stats", "config": {}}, b"")
    stats = json.loads(st)
    assert stats["requests_done"] >= 1 and stats["replicas"] == 1
    text = td.handle_request({"lab": "metrics"}, b"").decode()
    for name in ("ttft_seconds_bucket", "itl_seconds_count", "engine_requests_done",
                 "engine_requests_done_replica0", "daemon_shed_requests", "engine_mfu"):
        assert name in text, name
    slow = json.loads(td.handle_request({"lab": "slowlog", "config": {"n": 50}},
                                                      b""))
    assert any(e["tag"] == "probe" for e in slow["worst"])
    j = json.loads(td.handle_request(
        {"lab": "journey", "config": {"tag": "probe"}}, b""))["journey"]
    assert j["completed"] and j["tag"] == "probe"
    dump = json.loads(td.handle_request({"lab": "trace_dump"}, b""))
    assert any(e["name"] == "engine.retire" for e in dump["traceEvents"])
    cs = json.loads(td.handle_request({"lab": "compile_stats"}, b""))
    assert {"programs", "peaks", "mfu", "steady_recompiles"} <= set(cs)
    pm = json.loads(td.handle_request({"lab": "postmortem"}, b""))
    assert "bundles" in pm


@pytest.mark.parametrize("config,payload", [
    ({"steps": 0}, PROMPT), ({}, b""), ({"attn": "wat"}, PROMPT),
    ({"kv_dtype": "fp4"}, PROMPT), ({"stop_byte": 300}, PROMPT),
    ({"speculative": True, "temperature": 0.5}, PROMPT),
    ({"prompt_lookup": True, "speculative": True}, PROMPT),
    ({"speculative": True, "draft_k": 9}, PROMPT),
    ({"prompt_lookup": True, "attn": "pallas"}, PROMPT),
    ({"deadline_ms": 0}, PROMPT), ({"hedge_ms": -1}, PROMPT),
    ({"prefill_chunk": -2}, PROMPT)])
def test_error_texts_match(daemons, config, payload):
    errs = []
    for mod in (td, jd):
        with pytest.raises(ValueError) as e:
            mod.handle_request({"lab": "generate", "config": config}, payload)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_deadline_shed_line(daemons, monkeypatch):
    """A queue exists and the recent queue-wait p99 blows the deadline:
    both daemons answer ``shed retry_after_ms=N (...)`` before admission."""
    lines = []
    for mod, svc in ((td, td._ADMISSION), (jd, jd._GEN_SERVICE)):
        mod.handle_request(*_gen({"steps": 2}))  # warm the fleet
        _quiesce(mod)
        monkeypatch.setattr(svc, "_qw_marks", [])
        svc.prime_queue_wait()
        hist = mod._obs.REGISTRY.get("queue_wait_seconds")
        for _ in range(20):
            hist.observe(9.0)
        with mod._FLEET_SERVICE.lock:
            (fleet,) = [v[1] for v in mod._FLEETS.values()]
        (rep,) = fleet.replicas
        with rep.cond:  # a queue with no stepper: pending stays put
            rep.engine.submit(np.arange(4, dtype=np.int32), max_new=2)
        shed0 = mod._C_SHED.value
        with pytest.raises(mod.ShedError) as e:
            mod.handle_request(*_gen({"steps": 4, "deadline_ms": 5}))
        assert mod._C_SHED.value == shed0 + 1
        lines.append(str(e.value))
        with rep.cond:
            rep.engine.pending.clear()
    assert lines[0] == lines[1]
    assert lines[0].startswith("shed retry_after_ms=5000 (queue_wait p99 ")
    assert tload.SHED_RE.search(lines[0]) is not None


# ------------------------------------------------------------------ the fleet

def _no_leak(eng):
    cached = {b for blocks in eng.prefix_cache.values() for b in blocks}
    assert len(eng.free) + len(cached) == eng.n_usable_blocks
    assert sorted(set(eng.free)) == sorted(eng.free)


def _concurrent(mod, configs):
    out, errs = [None] * len(configs), []

    def one(i, cfg):
        try:
            out[i] = mod.handle_request(*_gen(cfg["config"], cfg["payload"]))
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(repr(e))

    threads = []
    for i, cfg in enumerate(configs):
        th = threading.Thread(target=one, args=(i, cfg))
        th.start()
        threads.append(th)
        time.sleep(0.02)  # alternate placement across the replicas
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errs, errs
    return out


def test_crash_on_replica1_migrates_bit_equal(daemons, monkeypatch):
    monkeypatch.setattr(td, "REPLICAS", 2)
    configs = [{"config": {"steps": 12, "tag": f"m{i}"},
                "payload": bytes(((np.arange(9 + i) + i) % 7).astype(np.uint8))}
               for i in range(4)]
    want = [jd.handle_request(*_gen(c["config"], c["payload"])) for c in configs]
    m0, r0 = td._C_MIGRATIONS.value, td._C_RESTARTS.value
    with tfaults.active([{"site": "paged.tick@replica1", "kind": "raise", "at": 3}]) as inj:
        got = _concurrent(td, configs)
        assert inj.fired() == {"paged.tick@replica1": 1}
    assert got == want
    assert td._C_MIGRATIONS.value >= m0 + 1 and td._C_RESTARTS.value == r0 + 1
    (fleet,) = _quiesce(td)
    status = td._FLEET_SERVICE.fleet_status(fleet)
    assert status["replica"][1]["generation"] == 1 and status["replica"][1]["restarts"] == 1
    pm = json.loads(td.handle_request({"lab": "postmortem"}, b""))
    assert pm["reason"] == "replica_quarantine" and pm["engine"]["replica_index"] == 1
    for r in fleet.replicas:
        with r.cond:
            _no_leak(r.engine)
    slow = td._obs.SLOWLOG.snapshot(64)["worst"]
    assert any(e["migrations"] >= 1 and e["tag"].startswith("m") for e in slow)


def test_drain_undrain_and_hedge(daemons, monkeypatch):
    monkeypatch.setattr(td, "REPLICAS", 2)
    want = jd.handle_request(*_gen({"steps": 10}))
    assert td.handle_request(*_gen({"steps": 10})) == want
    d0 = td._C_DRAINS.value
    row = json.loads(td.handle_request(
        {"lab": "drain", "config": {"replica": 0}}, b""))
    assert row["draining"] and td._C_DRAINS.value == d0 + 1
    deadline = time.monotonic() + 60
    while True:
        st = json.loads(td.handle_request({"lab": "fleet"}, b""))
        if st["replica"][0]["generation"] >= 1 or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert st["replica"][0]["generation"] == 1
    assert td.handle_request(*_gen({"steps": 10})) == want  # served by replica 1
    row = json.loads(td.handle_request(
        {"lab": "undrain", "config": {"replica": 0}}, b""))
    assert not row["draining"] and row["health"] == trouter.HEALTHY
    h0 = td._C_HEDGES.value
    assert td.handle_request(*_gen({"steps": 10, "hedge_ms": 0.001})) == want
    assert td._C_HEDGES.value == h0 + 1
    with pytest.raises(ValueError, match="replica must be in"):
        td.handle_request({"lab": "drain", "config": {"replica": 5}}, b"")


def test_socket_appears_only_once_it_listens(monkeypatch, tmp_path):
    """``serve()`` binds under a temporary name and renames once it
    listens: with ``listen`` held back, the path a client polls for is
    absent until then, and a connect as soon as it exists succeeds."""
    import socket

    class SlowListen(socket.socket):
        def listen(self, *a):
            time.sleep(0.5)
            super().listen(*a)

    monkeypatch.setattr(td, "BACKEND", "cpu")
    monkeypatch.setattr(td, "METRICS_INTERVAL_S", 0.0)
    monkeypatch.setattr(td.socket, "socket", SlowListen)
    path = str(tmp_path / "d.sock")
    stop = threading.Event()
    th = threading.Thread(target=td.serve, args=(path,), kwargs={"stop_event": stop},
                          daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 30
        while not os.path.exists(path):
            assert time.monotonic() < deadline, "the socket never appeared"
            time.sleep(0.001)
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(path)  # ECONNREFUSED where the path came before listen
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive() and not os.path.exists(path)


# ------------------------------------------------------------------ the mesh knobs

#: tpulab's eight mesh-knob rejections (tests/test_native.py), each raised
#: before any engine is built
MESH_REJECTIONS = (
    ({"tp": 0}, "tp must be >= 1"),
    ({"tp": 4096}, "mesh serving needs 4096 devices; this daemon has"),
    ({"mesh": "64x64"}, "mesh serving needs 4096 devices; this daemon has"),
    ({"tp": 2, "attn": "pallas"}, "attn='pallas' does not support mesh serving"),
    ({"tp": 2, "mesh": "1x2"}, "config sets both mesh and tp > 1"),
    ({"mesh": "nope"}, "mesh spec 'nope'"),
    ({"tp": 2, "beams": 2}, "mesh serving covers the engine decode path only"),
    ({"tp": 2, "speculative": True},
     "speculative (dense-draft) decoding is uncertified on mesh serving"),
)


@pytest.mark.parametrize("config,msg", MESH_REJECTIONS, ids=[str(c) for c, _ in MESH_REJECTIONS])
def test_mesh_knobs_rejected_before_any_build(config, msg, monkeypatch):
    monkeypatch.setattr(td, "BACKEND", "cpu")
    monkeypatch.setattr(td, "_FLEETS", {})
    monkeypatch.setattr(td, "_build_engine", lambda *a, **k: pytest.fail("an engine was built"))
    with pytest.raises(ValueError, match=re.escape(msg)):
        td.handle_request({"lab": "generate", "config": {"steps": 2, **config}}, b"x")
    with pytest.raises(ValueError, match=re.escape(msg)):
        jd.handle_request({"lab": "generate", "config": {"steps": 2, **config}}, b"x")


@pytest.mark.parametrize("spec", ["nope", "2x", "0x4"])
def test_malformed_mesh_flag_exits_2(spec, tmp_path):
    """``--mesh`` is parsed and canonicalized at the argparse boundary, as
    ``tpulab``'s (``tests/test_mesh_serving.py``): a bad spec exits 2."""
    with pytest.raises(SystemExit) as e:
        td.main(["--backend", "cpu", "--socket", str(tmp_path / "s.sock"), "--mesh", spec])
    assert e.value.code == 2
