"""``tpulab_torch.daemon`` on the serving mesh, over gloo ranks on the CPU
(``tests/test_native.py``'s ``test_generate_tp_mesh_over_wire`` and
``test_generate_tp_rejected_cleanly``, and ``__graft_entry__.py``'s
``_daemon_on_mesh_wire``, for the port).

``trained_small``'s weights, carried over with ``Labformer.from_numpy``,
are saved as a port checkpoint with its sidecar.  One ``python -m
tpulab_torch.daemon --backend cpu`` serves them for the module: two
concurrent clients with ``{"tp": 2}``, ``{"mesh": "1x2"}``, ``"2x1"`` and
``"2x2"`` read bytes equal to the port's one-device engine and to
``tpulab``'s engine built by its daemon's recipe (greedy: bit-equal);
``tpulab``'s eight rejections come back as error frames with its messages;
the ``slowlog``, ``journey``, ``trace_dump`` and ``metrics`` answers for
mesh requests carry what a one-device request's carry; a rank killed
mid-wave quarantines its replica, which rebuilds on fresh ranks and replays
to the fault-free bytes; and no rank outlives the daemon's SIGTERM.  A
malformed ``--mesh`` exits 2.

In this process, over :func:`~tpulab_torch.parallel.mesh.shared_pool`'s
two ranks: a journaled mesh request recovers on the mesh; an injected
``paged.step`` fault on a mesh replica replays to the fault-free bytes;
placement and the prefix cache on a fleet of two mesh replicas give one
device's bytes, hits and per-replica counts; prefill and decode pools
hand off between mesh replicas as between one-device ones; a rank's death
fails both replicas that share its pool, and both come back; phase 17 of
``chip_smoke.py`` rehearses at a tiny size; and ``RankPool.run`` called
from many threads at once, with a collective inside each call, keeps one
call order on every rank.

The ranks import this module, so it imports neither JAX nor ``tpulab`` at
its top: the ``J`` fixture does.
"""

import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpulab_torch.daemon as td
from tpulab_torch import ckpt, client
from tpulab_torch import durability as tdur
from tpulab_torch import faults as tfaults
from tpulab_torch.models import labformer as tlf
from tpulab_torch.parallel.mesh import shared_pool
from tpulab_torch.parallel.mesh_engine import MeshEngine

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the wire's mesh knobs, each over two or four ranks
KNOBS = {"tp2": {"tp": 2}, "1x2": {"mesh": "1x2"}, "2x1": {"mesh": "2x1"},
         "2x2": {"mesh": "2x2"}}
PROMPTS = [bytes((np.arange(21) % 7).astype(np.uint8)),
           bytes((np.arange(3, 40) % 5).astype(np.uint8))]
STEPS = 12


@pytest.fixture(scope="module")
def J():
    import tpulab.daemon as jd
    from tpulab.models import labformer as jlf
    from tpulab.models import paged as jpaged

    return types.SimpleNamespace(jd=jd, jlf=jlf, jpaged=jpaged)


@pytest.fixture(scope="module")
def ck(tmp_path_factory, trained_small, trained_small_cfg, J):
    """``trained_small`` as a port checkpoint with its sidecar; (path,
    the port's config)."""
    cfg = tlf.cfg_from_dict(J.jlf.cfg_to_dict(trained_small_cfg))
    path = str(tmp_path_factory.mktemp("meshck") / "ck")
    ckpt.save(path, 0, tlf.Labformer.from_numpy(trained_small, cfg, "cpu"))
    ckpt.write_sidecar(path, cfg)
    return path, cfg


def _engine_bytes(eng, prompts, steps):
    ids = [eng.submit(np.frombuffer(p, np.uint8).astype(np.int32), max_new=steps)
           for p in prompts]
    done = eng.run()
    return [bytes(int(t) & 0xFF for t in done[i]) for i in ids]


@pytest.fixture(scope="module")
def one_device(ck):
    """``prompts -> bytes`` of the port's one-device engine, built by the
    daemon's own recipe on the checkpoint."""
    path, _ = ck
    old = td.BACKEND
    td.BACKEND = "cpu"
    try:
        eng, _ = td._build_engine(os.path.realpath(path), "gather", "native", td.PREFILL_CHUNK)
    finally:
        td.BACKEND = old
    return lambda prompts, steps: _engine_bytes(eng, prompts, steps)


@pytest.fixture(scope="module")
def tpulab_bytes(trained_small, trained_small_cfg, J):
    """``tpulab``'s engine by its daemon's recipe, on the same weights."""
    eng = J.jpaged.PagedEngine(trained_small, trained_small_cfg, slots=4, n_blocks=128,
                               block_size=16, max_seq=J.jd._SERVE_MAX_SEQ,
                               prefill_chunk=J.jd.PREFILL_CHUNK)
    return _engine_bytes(eng, PROMPTS, STEPS)


def _alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie awaiting its reaper does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshd")
    sock = str(d / "mesh.sock")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               TPULAB_POSTMORTEM_DIR=str(d / "pm"))
    log_path = d / "daemon.log"
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpulab_torch.daemon", "--backend", "cpu",
             "--socket", sock, "--slowlog", "64"],
            env=env, stdout=log_f, stderr=subprocess.STDOUT, cwd=str(ROOT))
        try:
            for _ in range(600):
                if os.path.exists(sock):
                    break
                if proc.poll() is not None:
                    raise RuntimeError(f"daemon died: {log_path.read_text()[-4000:]}")
                time.sleep(0.05)
            else:
                raise RuntimeError("daemon socket never appeared")
            yield types.SimpleNamespace(sock=sock, proc=proc, log=log_path)
        finally:
            if proc.poll() is None:
                proc.terminate()
            proc.wait(timeout=60)


def _concurrent(sock, config, prompts, stream=False):
    """Every prompt as its own client thread, all at once; the bytes."""
    out, errors = [None] * len(prompts), []

    def one(i):
        try:
            out[i] = client.request(sock, "generate", {**config, "stream": stream},
                                    prompts[i], on_chunk=(lambda c: None) if stream else None)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not errors and all(o is not None for o in out), errors
    return out


# ------------------------------------------------------------ the wire


@pytest.mark.parametrize("knob", list(KNOBS))
def test_mesh_over_wire_bit_equal(daemon, ck, one_device, tpulab_bytes, knob):
    path, _ = ck
    got = _concurrent(daemon.sock, {"ckpt_dir": path, "steps": STEPS, **KNOBS[knob]}, PROMPTS)
    assert got == one_device(PROMPTS, STEPS) == tpulab_bytes
    fleet = json.loads(client.request(daemon.sock, "fleet", {"ckpt_dir": path,
                                                             **KNOBS[knob]}))
    (row,) = fleet["replica"]
    n = 4 if knob == "2x2" else 2
    assert len(row["ranks"]) == n and row["health"] == "healthy" and row["restarts"] == 0
    st = json.loads(client.request(daemon.sock, "generate_stats", {"ckpt_dir": path,
                                                                  **KNOBS[knob]}))
    assert st["mesh_devices"] == n and st["requests_done"] == len(PROMPTS)


#: tpulab's eight rejections (tests/test_native.py), each before any build
REJECTIONS = (
    ({"tp": 0}, "tp must be >= 1"),
    ({"tp": 4096}, "mesh serving needs 4096 devices; this daemon has"),
    ({"mesh": "64x64"}, "mesh serving needs 4096 devices; this daemon has"),
    ({"tp": 2, "attn": "pallas"}, "attn='pallas' does not support mesh serving"),
    ({"tp": 2, "mesh": "1x2"}, "config sets both mesh and tp > 1"),
    ({"mesh": "nope"}, "mesh spec 'nope'"),
    ({"tp": 2, "beams": 2}, "mesh serving covers the engine decode path only"),
    ({"tp": 2, "speculative": True}, "speculative (dense-draft) decoding is uncertified on "
                                     "mesh serving"),
)


@pytest.mark.parametrize("config,msg", REJECTIONS, ids=[str(c) for c, _ in REJECTIONS])
def test_mesh_rejections_over_wire(daemon, config, msg):
    with pytest.raises(RuntimeError, match=re.escape(msg)):
        client.request(daemon.sock, "generate", {"steps": 2, **config}, b"x")


def test_malformed_mesh_flag_exits_2(tmp_path):
    res = subprocess.run([sys.executable, "-m", "tpulab_torch.daemon", "--backend", "cpu",
                          "--socket", str(tmp_path / "s.sock"), "--mesh", "2x"],
                         cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "--mesh: mesh spec '2x'" in res.stderr, res.stderr


def _prom(text: str, name: str) -> float:
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def test_obs_answers_name_mesh_requests(daemon, ck):
    """The slow log, the journeys, the trace and the latency histograms
    record a mesh request as they record a one-device request."""
    path, _ = ck
    sock = daemon.sock
    # prompts neither fleet has cached, so both prefill alike
    prompts = [bytes((np.arange(n) % 3 + 100).astype(np.uint8)) for n in (19, 35)]
    before = client.request(sock, "metrics").decode()
    for name, knob in (("one", {}), ("mesh", {"mesh": "1x2"})):
        for i, p in enumerate(prompts):
            client.request(sock, "generate", {"ckpt_dir": path, "steps": STEPS,
                                              "tag": f"obs-{name}-{i}", **knob}, p)
    after = client.request(sock, "metrics").decode()
    for h in ("ttft_seconds", "e2e_seconds", "queue_wait_seconds", "prefill_seconds"):
        assert _prom(after, f"{h}_count") - _prom(before, f"{h}_count") == 2 * len(prompts), h
    assert _prom(after, "itl_seconds_count") - _prom(before, "itl_seconds_count") == \
        2 * len(prompts) * (STEPS - 1)
    slow = json.loads(client.request(sock, "slowlog", {"n": 64}))["worst"]
    trace = json.loads(client.request(sock, "trace_dump"))["traceEvents"]
    timing = {"e2e_ms", "queue_wait_ms", "prefill_ms", "ttft_ms", "itl_max_ms",
              "itl_max_at_token", "rid", "tag"}
    for i in range(len(prompts)):
        rows = {}
        for name in ("one", "mesh"):
            tag = f"obs-{name}-{i}"
            (entry,) = [e for e in slow if e["tag"] == tag]
            j = json.loads(client.request(sock, "journey", {"tag": tag}))["journey"]
            assert j["rid"] == entry["rid"] and j["completed"]
            names = sorted({e["name"] for e in trace
                            if e.get("args", {}).get("arg") == entry["rid"]})
            rows[name] = ({k: v for k, v in entry.items() if k not in timing},
                          [p["phase"] for p in j["phases"]], names)
        assert rows["mesh"] == rows["one"]
        assert {"engine.submit", "engine.admit", "engine.first_token",
                "engine.retire"} <= set(rows["mesh"][2])


def _wait(pred, timeout=60.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} never held")


def test_rank_killed_mid_wave_replays(daemon, ck, one_device):
    path, _ = ck
    sock, knob, steps = daemon.sock, {"mesh": "1x2"}, 160
    want = one_device(PROMPTS, steps)
    client.request(sock, "generate", {"ckpt_dir": path, "steps": 2, **knob}, b"warm")
    (row,) = json.loads(client.request(sock, "fleet", {"ckpt_dir": path, **knob}))["replica"]
    ranks, restarts = row["ranks"], row["restarts"]
    out, errors, started = [None, None], [], threading.Event()

    def one(i):
        try:
            out[i] = client.request(sock, "generate", {"ckpt_dir": path, "steps": steps,
                                                       "stream": True, **knob},
                                    PROMPTS[i], on_chunk=lambda c: started.set())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    assert started.wait(120), "no chunk arrived"
    os.kill(ranks[1], signal.SIGKILL)
    for th in threads:
        th.join(timeout=300)
    assert not errors and out == want, errors
    (row,) = json.loads(client.request(sock, "fleet", {"ckpt_dir": path, **knob}))["replica"]
    assert row["restarts"] == restarts + 1 and row["generation"] >= 1
    assert row["health"] == "healthy" and not set(row["ranks"]) & set(ranks)
    assert not any(_alive(pid) for pid in ranks)
    assert _concurrent(sock, {"ckpt_dir": path, "steps": STEPS, **knob}, PROMPTS) == \
        one_device(PROMPTS, STEPS)


# ------------------------------------------------------------ in this process


@pytest.fixture
def inproc(ck, monkeypatch):
    monkeypatch.setattr(td, "BACKEND", "cpu")
    monkeypatch.setattr(td, "_FLEETS", {})
    monkeypatch.setattr(td, "_RESUME", {})
    monkeypatch.setattr(td, "_JOURNAL", None)
    monkeypatch.setattr(td, "REPLICAS", 1)
    yield ck[0]
    tfaults.disable()


def _gen(config, payload):
    return td.handle_request({"lab": "generate", "config": config}, payload)


def test_journaled_mesh_request_recovers_on_the_mesh(inproc, one_device, tmp_path):
    path = inproc
    want = one_device(PROMPTS[:1], STEPS)[0]
    jpath = tmp_path / "j.jsonl"
    j = tdur.Journal(jpath, ckpt_every=5)
    j.append_accept("m-rec", "mr", PROMPTS[0], {"steps": STEPS, "rid": "m-rec",
                                                "ckpt_dir": path, "mesh": "1x2"})
    j.note_tokens("m-rec", list(want[:5]))
    j.close()
    jnl = tdur.Journal(jpath)
    assert td._recover_from_journal(jnl) == 1
    got = td.handle_request({"lab": "resume", "config": {"rid": "m-rec", "received": 0}}, b"")
    jnl.close()
    assert got == want
    (key,) = td._FLEETS
    assert key[-1] == "1x2"
    assert isinstance(td._FLEETS[key][1].replicas[0].engine, MeshEngine)
    e = tdur.scan(jpath).entries["m-rec"]
    assert e.done["status"] == "ok" and bytes(e.done["tokens"]) == want


def test_injected_fault_on_a_mesh_replica_replays(inproc, one_device):
    path = inproc
    config = {"ckpt_dir": path, "steps": STEPS, "mesh": "1x2"}
    assert _gen(config, PROMPTS[0]) == one_device(PROMPTS[:1], STEPS)[0]  # warm, no fault
    r0 = td._C_RESTARTS.value
    tfaults.configure([{"site": "paged.step@replica0", "kind": "raise", "at": 4}])
    got = [None, None]
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, _gen(config, PROMPTS[i])))
               for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert got == one_device(PROMPTS, STEPS)
    assert td._C_RESTARTS.value == r0 + 1
    fleet = next(iter(td._FLEETS.values()))[1]
    assert fleet.replicas[0].generation == 1


def test_placement_and_prefix_cache_as_on_one_device(inproc, monkeypatch):
    """On two replicas: a long stream holds replica 0 while a second
    request goes to the idle replica 1 (load); then, one at a time, each
    replica takes the request whose prefix it holds (affinity).  The bytes,
    the prefix hits and each replica's share equal one device's."""
    path = inproc
    monkeypatch.setattr(td, "REPLICAS", 2)
    p_a, p_b = (bytes((np.arange(48) % k).astype(np.uint8)) for k in (7, 5))
    runs = {}
    for name, knob in (("one", {}), ("mesh", {"mesh": "1x2"})):
        config = {"ckpt_dir": path, **knob}
        started, long = threading.Event(), []
        th = threading.Thread(target=lambda: long.append(td.handle_request(
            {"lab": "generate", "config": {**config, "steps": 150, "stream": True}},
            p_a + b"\x01", send_chunk=lambda c: started.set())))
        th.start()
        assert started.wait(60)
        outs = [_gen({**config, "steps": 6}, p_b + b"\x02")]
        th.join(timeout=120)
        outs += long + [_gen({**config, "steps": 6}, p + tail)
                        for p, tail in ((p_b, b"\x03"), (p_a, b"\x04"))]
        st = json.loads(td.handle_request({"lab": "generate_stats", "config": config}, b""))
        rows = json.loads(td.handle_request({"lab": "fleet", "config": config}, b""))
        runs[name] = (outs, st["prefix_hits"], [r["requests_done"] for r in rows["replica"]])
    assert runs["mesh"] == runs["one"]
    assert runs["one"][1] == 2 and runs["one"][2] == [2, 2]


def test_pools_hand_off_between_mesh_replicas(inproc, one_device, monkeypatch):
    """``--pool-spec prefill=1,decode=1`` on the mesh: the prefill replica's
    export is rank 0's one-device payload, every decode rank imports it and
    keeps its heads; bytes, handoffs and handoff bytes equal one device's."""
    path = inproc
    monkeypatch.setattr(td, "POOL_SPEC", "prefill=1,decode=1")
    monkeypatch.setattr(td, "PREFIX_INDEX", "radix")
    monkeypatch.setattr(td, "SPILL_BLOCKS", 32)
    runs = {}
    for name, knob in (("one", {}), ("mesh", {"mesh": "1x2"})):
        h0, b0 = td._C_HANDOFFS.value, td._C_HANDOFF_BYTES.value
        outs = [_gen({"ckpt_dir": path, "steps": STEPS, **knob}, p) for p in PROMPTS]
        runs[name] = (outs, td._C_HANDOFFS.value - h0, td._C_HANDOFF_BYTES.value - b0)
    assert runs["mesh"] == runs["one"]
    assert runs["one"][0] == one_device(PROMPTS, STEPS)
    assert runs["one"][1] == len(PROMPTS) and runs["one"][2] > 0


def test_rank_death_fails_every_replica_on_its_ranks(inproc, one_device, monkeypatch):
    """Two mesh replicas share one pool's ranks.  One rank dies while both
    are idle: placement finds both engines lost, fails each (quarantine,
    rebuild on a fresh pool) and the request is served with one device's
    bytes once they are back."""
    path = inproc
    monkeypatch.setattr(td, "REPLICAS", 2)
    config = {"ckpt_dir": path, "steps": STEPS, "mesh": "1x2"}
    assert _gen(config, PROMPTS[0]) == one_device(PROMPTS[:1], STEPS)[0]
    fleet = next(iter(td._FLEETS.values()))[1]
    pids = {pid for r in fleet.replicas for pid in r.engine.rank_pids}
    assert len(pids) == 2  # one pool under both replicas
    r0 = td._C_RESTARTS.value
    os.kill(sorted(pids)[1], signal.SIGKILL)
    _wait(lambda: not _alive(sorted(pids)[1]), 30, "the rank ended")
    assert _gen(config, PROMPTS[1]) == one_device(PROMPTS[1:], STEPS)[0]
    assert td._C_RESTARTS.value == r0 + 2
    _wait(lambda: all(r.generation == 1 for r in fleet.replicas), 60, "both rebuilt")
    fresh = {pid for r in fleet.replicas for pid in r.engine.rank_pids}
    assert len(fresh) == 2 and not fresh & pids


def test_chip_smoke_phase17_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's phase 17 at a tiny size on the CPU, its rank a gloo
    rank: 17a's mesh replica bit-equal to one device's (stats, slow log,
    journeys and trace alike), 17b's replay, 17c's device-count message,
    17d's turns and round trip."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    for name in ("BACKEND", "REPLICAS", "_FLEETS"):
        monkeypatch.setattr(td, name, getattr(td, name) if name != "_FLEETS" else {})
    tiny = dict(chip_smoke.FULL_SIZES)
    tiny.update(daemon_serving=dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=128),
                daemon_clients=4, daemon_prompt_len=(20, 40), daemon_gen_steps=6,
                daemon_mesh_reps=5)
    out = chip_smoke.run_daemon_mesh(tiny, torch.device("cpu"), "cpu", "cpu")
    assert out["a"]["bytes_equal"] and out["a"]["ticks"] > 0
    assert out["b"] == {"restarts": 1, "bytes_equal": True}
    assert out["c"].startswith("mesh serving needs ")
    assert [t["engine"] for t in out["d"]["turns"]] == ["one", "mesh", "mesh", "one"]
    assert out["d"]["pool_round_trip_ms"] > 0


# ------------------------------------------------------------ RankPool's lock

#: this rank's calls, in the order it ran them
_ORDER: list = []


def _ordered(tag):
    """An all-reduce, then note ``tag``: a call whose collective pairs with
    another thread's call would hang or sum a wrong count."""
    t = torch.ones(1)
    dist.all_reduce(t)
    _ORDER.append(tag)
    return int(t.item())


def _orders():
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, list(_ORDER))
    return out


def test_rankpool_run_is_serialized_across_threads():
    """More threads than cores call one pool at once, the interpreter
    switching threads often: every call's all-reduce pairs with its own
    call in the other rank, and both ranks ran the calls in one order."""
    pool = shared_pool(2, "cpu")
    n_threads, n_calls = os.cpu_count() + 4, 4
    sums, errors = [], []

    def worker(w):
        try:
            for i in range(n_calls):
                sums.append(pool.run(_ordered, (w, i)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads), "a pool call hung"
    assert not errors and sums == [2] * (n_threads * n_calls), errors
    ranks = pool.run(_orders)
    assert ranks[0] == ranks[1]
    mine = [t for t in ranks[0] if isinstance(t, tuple)][-n_threads * n_calls:]
    assert sorted(mine) == [(w, i) for w in range(n_threads) for i in range(n_calls)]


# ------------------------------------------------------------ shutdown (last)


def test_no_rank_outlives_sigterm(daemon, ck):
    path, _ = ck
    pids = []
    for knob in KNOBS.values():
        st = json.loads(client.request(daemon.sock, "fleet", {"ckpt_dir": path, **knob}))
        pids += [pid for row in st["replica"] for pid in row.get("ranks", [])]
    assert len(set(pids)) >= 6 and all(_alive(p) for p in pids)
    daemon.proc.send_signal(signal.SIGTERM)
    assert daemon.proc.wait(timeout=60) == 0
    _wait(lambda: not any(_alive(p) for p in pids), 30, "every rank gone after SIGTERM")
    assert "graceful shutdown" in daemon.log.read_text()
